"""The port's CUDA kernels (fused FFN K1/K1b, fused attention module K2/K2b,
fused convolution module K3/K3b and its data-parallel form K3dp, flash
attention K4 and its backward K4b, stem K5 in eval and in training) against
their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where JAX
is absent. On a machine with an NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q

Tests marked `cuda` decide inside a fixture whether a card is present and
skip without one; the others run on the CPU, where each wrapper computes its
plain version. Tolerances: fp32 max abs 1e-4; flash bf16 2e-2 (bf16 inputs,
fp32 accumulation in both), the bf16 forward's out within a relative L1
error of 1e-4 (p kept at fp32 precision) and the same bits over two calls;
stem bf16 exact (a max of identically rounded
values), on odd frames too; whole-model fp32 logits 2e-3. FFN: fp32 1e-4
for y and dx and 3e-4 of the largest entry for the parameter gradients
(atomic sums over all rows);
bf16 2e-2 / 3e-2 of the largest entry; the bf16 forward and backward give
the same bits over two calls. Flash backward: fp32 1e-4, bf16 3e-2
of the largest entry; in bf16 a relative L1 error (sum |got - want| / sum
|want|) within 1e-4 (p and dS kept at fp32 precision), the same bits over
two calls. Attention module: fp32 1e-4 for y and 5e-4 for dx and
the parameter gradients, bf16 2e-2 / 3e-2, all of the largest entry, and
the bf16 parameter gradients within 2e-3 as well (the backward's fp32
operands kept at fp32 precision); the bf16 forward and backward give the same
bits over two calls; dropout masks identical entry by entry. Train-mode stem, kernel route against plain
route: fp32 1e-5 (pooled, mean, var) and 1e-4 of the largest entry
(gradients); bf16 exact forward, gradients 1e-2 (atomic-free library sums in
another order); conv-bias gradient exactly zero. Convolution module, kernels
against the plain stages: fp32 1e-4 of the largest entry for y, mean and var
and 5e-4 for dx and the parameter gradients (atomic sums over all rows); bf16
2e-2 and 3e-2; dropout masks identical entry by entry; the depthwise-bias
gradient exactly zero; the stats pass (fp32 and bf16), the bf16 forward and
both bf16 backward passes give the same bits over two calls. K3dp on two gloo ranks sharing the card
against one K3/K3b call on the whole batch: the convolution module's
tolerances.
"""

import numpy as np
import pytest
import torch

from avec_tpu_torch.ops import _cuda, conv_module
from avec_tpu_torch.ops import flash_attention as flash_ops
from avec_tpu_torch.ops.attention_module import (
    fused_attention_module_3d, fused_attention_module_reference)
from avec_tpu_torch.ops.conv_module import (KERNELS as CONV_KERNELS,
                                            PARAM_NAMES as CONV_PARAMS,
                                            batch_stats, conv_fwd_reference,
                                            conv_stats_reference,
                                            fused_conv_module_3d)
from avec_tpu_torch.ops.ffn import (dropout_mask, fused_ffn,
                                    fused_ffn_reference)
from avec_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_bwd_reference,
                                                flash_attention_fwd,
                                                flash_attention_reference)
from avec_tpu_torch.ops.stem import (bn_relu_pool, bn_relu_pool_reference,
                                     fused_stem_train)

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _flash_inputs(device, dtype, t, da, dv, lengths, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(len(lengths), 4, t, d, generator=gen)
               for d in (da, da, dv))
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [a.to(device, dtype) for a in (q, k, v)] + [lens.to(device)]


def _ffn_inputs(device, dtype, n, d, f, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen).to(device, dtype)
    params = [1.0 + 0.1 * torch.randn(d, generator=gen),
              0.1 * torch.randn(d, generator=gen),
              torch.randn(f, d, generator=gen) / d ** 0.5,
              0.1 * torch.randn(f, generator=gen),
              torch.randn(d, f, generator=gen) / f ** 0.5,
              0.1 * torch.randn(d, generator=gen)]
    return x, [p.to(device) for p in params]


def _att_inputs(device, dtype, b, t, d, seed=0):
    """x, cotangent and the twelve parameters in the port's layout."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, d, generator=gen).to(device, dtype)
    g = torch.randn(b, t, d, generator=gen).to(device, dtype)
    vec = lambda: 0.1 * torch.randn(d, generator=gen)
    mat = lambda: torch.randn(d, d, generator=gen) / d ** 0.5
    params = [1.0 + vec(), vec()]
    for _ in range(5):
        params += [mat(), vec()]
    return x, g, [p.to(device) for p in params]


def _conv_inputs(device, dtype, b, t, d, e, k, seed=0):
    """x, cotangent and the convolution module's ten parameters in the
    port's Conv layout (E' = E)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, d, generator=gen).to(device, dtype)
    g = torch.randn(b, t, e, generator=gen).to(device, dtype)
    vec = lambda n: 0.1 * torch.randn(n, generator=gen)
    u = lambda shape, fan: ((2 * torch.rand(shape, generator=gen) - 1)
                            / fan ** 0.5)
    params = [1.0 + vec(d), vec(d), u((2 * e, d, 1), d), u((2 * e,), d),
              u((e, 1, k), k), u((e,), k), 1.0 + vec(e), vec(e),
              u((e, e, 1), e), u((e,), e)]
    return x, g, [p.to(device) for p in params]


def _conv_run(x, g, params, padding, drop, use_kernel, seed=99):
    """y, batch mean and variance, and the gradients of x and the ten
    parameters."""
    leaves = [a.detach().requires_grad_(True) for a in [x] + params]
    y, mean, var = fused_conv_module_3d(
        leaves[0], *leaves[1:], seed=seed, padding=padding, drop_rate=drop,
        deterministic=False, use_kernel=use_kernel)
    y.backward(g)
    return [y.detach(), mean, var], [a.grad for a in leaves]


ATT_NAMES = ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv",
             "pos_w", "pos_b", "wo", "bo")


def _rel(a, b) -> float:
    """Max abs difference relative to the largest entry of b."""
    return _err(a, b) / max(float(b.float().abs().max()), 1e-30)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper returns its plain version and launches
    nothing."""
    before = dict(_cuda.launches)
    q, k, v, lens = _flash_inputs("cpu", torch.float32, 19, 13, 6, [19, 1])
    out, lse = flash_attention_fwd(q, k, v, lens, 0.5)
    want, want_lse = flash_attention_reference(q, k, v, lens, 0.5)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    y = torch.randn(3, 9, 10, 8)
    a, b = torch.rand(8) + 0.5, torch.randn(8)
    got = bn_relu_pool(y, a, b)
    assert got.shape == (3, 5, 5, 8)
    assert torch.equal(got, bn_relu_pool_reference(y, a, b))
    x, params = _ffn_inputs("cpu", torch.float32, 9, 12, 20)
    assert torch.equal(fused_ffn(x, *params, 5, 1e-6, 0.2, True),
                       fused_ffn_reference(x, *params, 5, 1e-6, 0.2, True))
    xa, _, pa = _att_inputs("cpu", torch.float32, 2, 9, 8)
    kw = dict(num_heads=2, lengths=torch.tensor([9, 4]), seed=3,
              drop_rate=0.2)
    assert torch.equal(
        fused_attention_module_3d(xa, *pa, deterministic=False, **kw),
        fused_attention_module_reference(xa, *pa, train=True, **kw))
    dout = torch.randn_like(v)
    delta = (dout * out).sum(-1).reshape(lse.shape)
    for a, b in zip(flash_attention_bwd(q, k, v, dout, lse, delta, lens, 0.5),
                    flash_attention_bwd_reference(q, k, v, dout, lse, delta,
                                                  lens, 0.5)):
        assert torch.equal(a, b)
    assert dict(_cuda.launches) == before


def test_cpu_conv_module_takes_the_plain_stages():
    """On the CPU the fused convolution module is its plain stages and the
    batch-statistics glue, and launches nothing."""
    before = dict(_cuda.launches)
    x, _, params = _conv_inputs("cpu", torch.float32, 2, 11, 6, 8, 5)
    y, mean, var = fused_conv_module_3d(x, *params, seed=7, drop_rate=0.2,
                                        deterministic=False)
    s1, s2 = conv_stats_reference(x, params, 2)
    want_mean, want_var, rstd = batch_stats(s1, s2, 22, 1e-5)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    assert torch.equal(y, conv_fwd_reference(x, params, mean, rstd, 7, 2,
                                             drop_rate=0.2))
    assert dict(_cuda.launches) == before


def test_dropout_mask_is_a_function_of_the_global_row():
    """The hash masks do not depend on how many rows are asked for, keep
    about `keep` of the entries and scale by 1/keep."""
    full = dropout_mask(11, 600, 24, 1, 0.7)
    assert torch.equal(full[:300], dropout_mask(11, 300, 24, 1, 0.7))
    assert set(full.unique().tolist()) == {0.0, float(np.float32(1 / 0.7))}
    assert abs(float((full > 0).float().mean()) - 0.7) < 0.02
    assert not torch.equal(full, dropout_mask(12, 600, 24, 1, 0.7))
    assert not torch.equal(full[:, :24], dropout_mask(11, 600, 24, 2, 0.7))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without nvcc the build raises."""
    if _cuda._libs:
        pytest.skip("kernels already built in this process")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()


@pytest.mark.parametrize("name", ["ffn", "flash_attention_bwd",
                                  "flash_attention", "stem",
                                  "attention_module", "conv_module",
                                  "batch_norm"])
def test_missing_nvcc_raises_for_every_library(monkeypatch, tmp_path, name):
    """Every kernel library is built from source: asking for any of them
    without nvcc raises instead of falling back."""
    if _cuda._libs:
        pytest.skip("kernels already built in this process")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert name + ".cu" in _cuda.SOURCES
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.library(name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,da,dv,lengths", [
    (201, 321, 64, [201, 160, 77, 1]),   # audio stage 1 of the 8 s bucket
    (101, 451, 90, [101, 51, 5, 1]),     # audio stage 2
    (37, 20, 7, [37, 0, 36, 2]),         # ragged widths, a row of length 0
    # the flash training route's B=16: 192 and 128 blocks
    (151, 321, 64, [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33, 17,
                    2, 1, 1]),
    (76, 451, 90, [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2, 1,
                   1]),
])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, t, da, dv,
                                    lengths):
    q, k, v, lens = _flash_inputs(cuda_device, dtype, t, da, dv, lengths)
    n0 = _cuda.launches["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, lens, 0.125)
    torch.cuda.synchronize()
    assert _cuda.launches["flash_attention_fwd"] == n0 + 1
    want, want_lse = flash_attention_reference(q, k, v, lens, 0.125)
    assert out.dtype == dtype and out.shape == want.shape
    assert _err(out, want) <= tol
    assert _err(lse, want_lse) <= tol


FLASH_FWD_SHAPES = [
    (201, 321, 64, [201, 160, 120, 101, 77, 40, 9, 1]),   # serving, B=8
    (101, 451, 90, [101, 80, 60, 51, 39, 20, 5, 1]),
    (151, 321, 64, [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33, 17,
                    2, 1, 0]),                            # training, B=16
    (76, 451, 90, [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2, 1,
                   0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,da,dv,lengths", FLASH_FWD_SHAPES)
def test_flash_bf16_forward_is_deterministic(cuda_device, t, da, dv,
                                             lengths):
    """Each bf16 output element and lse entry has one owner that walks the
    key tiles in a fixed order (no atomics): two calls give the same
    bits."""
    q, k, v, lens = _flash_inputs(cuda_device, torch.bfloat16, t, da, dv,
                                  lengths)
    runs = [flash_attention_fwd(q, k, v, lens, da ** -0.5) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("t,da,dv,lengths", FLASH_FWD_SHAPES + [
    (37, 20, 7, [37, 0, 36, 2]),           # ragged widths
])
def test_flash_bf16_forward_keeps_fp32_p(cuda_device, t, da, dv, lengths):
    """The TPU kernel multiplies p by v in fp32; the bf16 kernel feeds p to
    the tensor cores as three bf16 parts that sum to it exactly, so its out
    differs from the plain version's only where the two fp32 sums round to
    different bf16 values: a relative L1 error (sum |got - want| / sum
    |want|) far below 1e-4. The same call through a control build that
    rounds p to bf16 moves out by up to a bf16 step in a large share of its
    entries, about 1e-3, so the bound of 1e-4 tells the two apart. lse does
    not depend on the parts."""
    q, k, v, lens = _flash_inputs(cuda_device, torch.bfloat16, t, da, dv,
                                  lengths)
    scale = da ** -0.5
    want = flash_attention_reference(q, k, v, lens, scale)[0]
    got, lse = flash_attention_fwd(q, k, v, lens, scale)
    b, h = q.shape[:2]
    rounded, rounded_lse = torch.empty_like(got), torch.empty_like(lse)
    control = _cuda.control_library("flash_attention", flash_ops.ROUNDED_P)
    scratch = flash_ops.fwd_scratch(q, v)
    rc = flash_ops._lib(control)[0](
        *(a.data_ptr() for a in (q, k, v, lens, rounded, rounded_lse,
                                 scratch)),
        b * h, h, t, da, dv, scale, 1, _cuda.stream_ptr(q))
    assert rc == 0
    torch.cuda.synchronize()
    assert _rel_l1(got, want) <= 1e-4
    assert _rel_l1(rounded, want) > 1e-4


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_inputs(cuda_device):
    q, k, v, lens = _flash_inputs(cuda_device, torch.float32, 16, 8, 8, [16])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v, lens)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_fwd(q, k, v, lens.long())
    with pytest.raises(ValueError, match="d_v"):
        v2 = torch.zeros(1, 4, 16, 100, device=cuda_device)
        flash_attention_fwd(q, k, v2, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0)])
@pytest.mark.parametrize("n,h,w,c", [(37, 44, 44, 64), (5, 45, 43, 64),
                                     (7, 3, 5, 64), (4, 45, 43, 8),
                                     (9, 3, 5, 8), (3, 1, 2, 16)])
def test_stem_kernel_matches_plain(cuda_device, dtype, tol, n, h, w, c):
    """The stem's frames (44x44x64) and odd ones, whose last row and column
    clip the window (z >= 0, so clipping is the TPU kernel's zero padding):
    a thread's walk carries the last input row's max only where it
    exists."""
    gen = torch.Generator().manual_seed(1)
    y = torch.randn(n, h, w, c, generator=gen).to(cuda_device, dtype)
    a = (torch.rand(c, generator=gen) + 0.5).to(cuda_device)
    b = (torch.randn(c, generator=gen) * 0.2).to(cuda_device)
    n0 = _cuda.launches["bn_relu_pool"]
    got = bn_relu_pool(y, a, b)
    torch.cuda.synchronize()
    assert _cuda.launches["bn_relu_pool"] == n0 + 1
    assert got.shape == (n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c)
    assert got.dtype == dtype
    assert _err(got, bn_relu_pool_reference(y, a, b)) <= tol


@pytest.mark.cuda
def test_stem_kernel_rejects_bad_channels(cuda_device):
    """The kernel loads 16 bytes of channels a thread: C a multiple of 8 in
    bf16 and of 4 in fp32, else a ValueError and no launch."""
    n0 = _cuda.launches["bn_relu_pool"]
    for dtype, c in ((torch.bfloat16, 12), (torch.float32, 6)):
        y = torch.randn(2, 9, 9, c, device=cuda_device).to(dtype)
        a = torch.ones(c, device=cuda_device)
        with pytest.raises(ValueError, match="multiple of"):
            bn_relu_pool(y, a, a)
    assert _cuda.launches["bn_relu_pool"] == n0


@pytest.mark.cuda
def test_model_kernel_path_matches_plain_path(cuda_device):
    """A small AV model on the card: the kernel path (7 -> here 3 flash
    launches and 1 stem launch per forward) against the plain versions."""
    from avec_tpu_torch.serve import Server, _bucket

    srv = Server(device="cuda", precision="float32", vocab_size=32,
                 v_num_blocks=(2, 1), a_num_blocks=(2, 2, 1), f_num_blocks=2,
                 v_interctc_blocks=(2,), a_interctc_blocks=(2, 4),
                 f_interctc_blocks=(1,), use_flash=True, stem_mode="pallas")
    rng = np.random.RandomState(0)
    reqs = [{"audio": (rng.randn(n) * 0.1).astype(np.float32),
             "video": rng.rand(n // 640 + 1, 88, 88, 1).astype(np.float32)}
            for n in (16000, 27200)]
    inputs = srv._inputs_for_batch(reqs, _bucket(27200), 2)
    _cuda.reset_launches()
    got, got_len = srv.forward(inputs)
    assert dict(_cuda.launches) == {"flash_attention_fwd": 3,
                                    "bn_relu_pool": 1}
    srv.model.set_kernels(False)
    want, want_len = srv.forward(inputs)
    assert torch.equal(got_len, want_len)
    assert _err(got, want) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 1e-4, 3e-4),
                                            (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("n,d,f", [
    (16 * 301, 180, 720),    # audio stage 0 of a 6 s batch
    (16 * 151, 256, 1024),   # audio stage 1 and video stage 0
    (16 * 76, 360, 1440),    # the 360-wide stages
    (16 * 301 - 5, 180, 720),   # N no multiple of the backward's 64-row tile
    (16 * 151 - 5, 256, 1024),
    (16 * 76 - 5, 360, 1440),
    (40, 256, 1024),         # N below one row tile
    (77, 20, 70),            # no multiple of any tile
    (90, 17, 24),            # odd d: rows not 4-byte aligned
])
def test_ffn_kernels_match_plain(cuda_device, dtype, tol, wtol, drop, n, d, f):
    x, params = _ffn_inputs(cuda_device, dtype, n, d, f)
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(n, d, generator=gen).to(cuda_device, dtype)
    leaves = [x] + params
    got_grads, want_grads = [], []
    outs = []
    for use_kernel, store in ((True, got_grads), (False, want_grads)):
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        n0 = dict(_cuda.launches)
        y = fused_ffn(x, *params, 1234, 1e-6, drop, True, use_kernel)
        y.backward(g)
        torch.cuda.synchronize()
        delta = {k: _cuda.launches[k] - n0.get(k, 0)
                 for k in ("fused_ffn_fwd", "fused_ffn_bwd")}
        assert delta == ({"fused_ffn_fwd": 1, "fused_ffn_bwd": 1}
                         if use_kernel else
                         {"fused_ffn_fwd": 0, "fused_ffn_bwd": 0})
        outs.append(y.detach())
        store.extend(t.grad.clone() for t in leaves)
    assert outs[0].dtype == dtype
    if drop:
        assert torch.equal(outs[0] == 0, outs[1] == 0)   # the same hash masks
    assert _rel(outs[0], outs[1]) <= tol
    assert _rel(got_grads[0], want_grads[0]) <= tol
    for got, want in zip(got_grads[1:], want_grads[1:]):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= wtol


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f", [(16 * 301, 180, 720),
                                   (16 * 76 - 5, 360, 1440)])
def test_ffn_bf16_backward_is_deterministic(cuda_device, n, d, f):
    """The bf16 backward sums every gradient in a fixed order (no atomics):
    two calls give the same bits."""
    x, params = _ffn_inputs(cuda_device, torch.bfloat16, n, d, f)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(3)).to(
        cuda_device, torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.detach().requires_grad_(True) for t in [x] + params]
        fused_ffn(leaves[0], *leaves[1:], 1234, 1e-6, 0.1, True).backward(g)
        runs.append([t.grad.clone() for t in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f", [(16 * 76, 360, 1440),   # 19 row tiles
                                   (40, 256, 1024)])       # below one tile
def test_ffn_bf16_forward_is_deterministic(cuda_device, n, d, f):
    """The bf16 forward sums the partial outputs of its hidden ranges in a
    fixed order (no atomics): two calls give the same bits, one launch
    each."""
    x, params = _ffn_inputs(cuda_device, torch.bfloat16, n, d, f)
    ys = []
    for _ in range(2):
        n0 = _cuda.launches["fused_ffn_fwd"]
        with torch.no_grad():
            ys.append(fused_ffn(x, *params, 1234, 1e-6, 0.1, True))
        assert _cuda.launches["fused_ffn_fwd"] == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])


@pytest.mark.cuda
def test_ffn_kernel_rejects_bad_inputs(cuda_device):
    x, params = _ffn_inputs(cuda_device, torch.float32, 8, 16, 32)
    with pytest.raises(ValueError, match="W1 must be"):
        fused_ffn(x, params[0], params[1], params[2].t().contiguous(),
                  *params[3:])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fused_ffn(x.half(), *params)
    xw, pw = _ffn_inputs(cuda_device, torch.float32, 8, 400, 32)
    with pytest.raises(ValueError, match="above the kernels"):
        fused_ffn(xw, *pw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("t,da,dv,lengths", [
    (151, 321, 64, [151, 120, 77, 1]),   # audio stage 1 of a 6 s batch
    (76, 451, 90, [76, 51, 5, 0]),       # audio stage 2, one empty sequence
    (37, 20, 7, [37, 0, 36, 2]),         # ragged widths
])
def test_flash_backward_kernels_match_plain(cuda_device, dtype, tol, t, da,
                                            dv, lengths):
    q, k, v, lens = _flash_inputs(cuda_device, dtype, t, da, dv, lengths)
    q, k = q * 0.3, k * 0.3
    gen = torch.Generator().manual_seed(9)
    g = torch.randn(v.shape, generator=gen).to(cuda_device, dtype)
    grads = []
    for use_kernel in (True, False):
        leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
        n0 = dict(_cuda.launches)
        flash_attention(*leaves, lens, 0.125, use_kernel).backward(g)
        torch.cuda.synchronize()
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            assert _cuda.launches[name] - n0.get(name, 0) == int(use_kernel)
        grads.append([a.grad for a in leaves])
    for got, want in zip(*grads):
        assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
        assert _rel(got, want) <= tol
    valid = (torch.arange(t, device=cuda_device)[None, :]
             < lens[:, None])[:, None, :, None]
    for got in grads[0]:
        assert float((got.float() * (~valid)).abs().max()) == 0.0


def _flash_bwd_case(device, t, da, dv, lengths):
    """bf16 q', k', v, dO, the forward's lse, delta and the lengths of a
    flash backward call."""
    q, k, v, lens = _flash_inputs(device, torch.bfloat16, t, da, dv, lengths)
    q, k = q * 0.3, k * 0.3
    g = torch.randn(v.shape, generator=torch.Generator().manual_seed(9)).to(
        device, torch.bfloat16)
    scale = 1.0 / da ** 0.5
    out, lse = flash_attention_fwd(q, k, v, lens, scale)
    delta = (g.float() * out.float()).sum(-1).reshape(lse.shape)
    return q, k, v, g, lse, delta, lens, scale


FLASH_ROUTE_SHAPES = [
    (151, 321, 64, [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33, 17,
                    2, 1, 0]),                        # audio stage 2
    (76, 451, 90, [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2, 1,
                   0]),                               # audio stage 3
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,da,dv,lengths", FLASH_ROUTE_SHAPES)
def test_flash_backward_bf16_is_deterministic(cuda_device, t, da, dv,
                                              lengths):
    """Each bf16 output tile has one owner that sums its streamed tiles in a
    fixed order (no atomics): two calls give the same bits."""
    args = _flash_bwd_case(cuda_device, t, da, dv, lengths)
    runs = [flash_attention_bwd(*args) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _rel_l1(got, want) -> float:
    """sum |got - want| over sum |want|."""
    return float((got.float() - want.float()).abs().sum()
                 / want.float().abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("t,da,dv,lengths", FLASH_ROUTE_SHAPES + [
    (200, 128, 96, [200, 130, 64, 1]),     # whole column groups, T > 3 tiles
    (37, 20, 7, [37, 0, 36, 2]),           # ragged widths
])
def test_flash_backward_bf16_keeps_fp32_operands(cuda_device, t, da, dv,
                                                 lengths):
    """The TPU kernel multiplies p and dS in fp32; the bf16 kernels feed them
    to the tensor cores as three bf16 parts that sum to them exactly, so
    dq', dk' and dV differ from the plain version by its bf16 rounding of
    each entry, a relative L1 error (sum |got - want| / sum |want|) of about
    2e-6 on the H100. The same call with p and dS rounded to bf16 (a control
    build of the source) gives about 2e-3, so a bound of 1e-4 tells
    the two apart; the max error over the largest entry does not, as one
    bf16 step of an entry near the largest is up to 3.9e-3 of it."""
    args = _flash_bwd_case(cuda_device, t, da, dv, lengths)
    want = flash_attention_bwd_reference(*args)
    got = flash_attention_bwd(*args)
    q, k, v, g, lse, delta, lens, scale = args
    b, h = q.shape[:2]
    rounded = [torch.zeros_like(a) for a in (q, k, v)]
    scratch = flash_ops.bwd_scratch(q, v)
    control = _cuda.control_library("flash_attention_bwd",
                                    flash_ops.ROUNDED_OPERANDS)
    rc = flash_ops._lib_bwd(control)[0](
        *(a.data_ptr() for a in (q, k, v, g, lse, delta, lens, *rounded,
                                 scratch)),
        b * h, h, t, da, dv, scale, 1, flash_ops.BWD_ALL, _cuda.stream_ptr(q))
    assert rc == 0
    torch.cuda.synchronize()
    for a, r, w in zip(got, rounded, want):
        assert _rel(a, w) <= 3e-2
        assert _rel_l1(a, w) <= 1e-4
        assert _rel_l1(r, w) > 1e-4


@pytest.mark.cuda
def test_train_step_kernel_path_matches_plain_path(cuda_device):
    """A small AV model on the card: one forward + backward through the
    kernels against one through their plain versions, fp32, dropout and
    SpecAugment off."""
    from avec_tpu_torch.train.model import Trainer

    trainer = Trainer(device="cuda", precision="float32", seed=0,
                      vocab_size=32, v_num_blocks=(2, 1),
                      a_num_blocks=(2, 2, 1), f_num_blocks=2,
                      v_interctc_blocks=(2,), a_interctc_blocks=(2, 4),
                      f_interctc_blocks=(1,), use_flash=True, fused_ffn=True)
    rng = np.random.RandomState(0)
    alen = np.array([27200, 16000], np.int32)
    batch = {"inputs": [rng.rand(2, 43, 88, 88, 1).astype(np.float32),
                        alen // 640 + 1,
                        (rng.randn(2, 27200) * 0.1).astype(np.float32), alen],
             "targets": (rng.randint(1, 32, size=(2, 5)).astype(np.int32),
                         np.array([5, 3], np.int32))}
    trainer.model.set_regularization(False)
    results = []
    for kernels in (True, False):
        trainer.model.set_kernels(kernels)
        _cuda.reset_launches()
        losses, grads = trainer.loss_and_grads(batch)
        expected = trainer.model.kernel_launches_per_step() if kernels else {}
        assert dict(_cuda.launches) == expected
        results.append((losses, grads))
    (lk, gk), (lp, gp) = results
    assert abs(float(lk["loss"]) - float(lp["loss"])) <= 1e-3 * abs(float(lp["loss"]))
    gmax = max(float(g.abs().max()) for g in gp.values())
    compared = 0
    for name in gp:
        if float(gp[name].abs().max()) <= 1e-6 * gmax:
            continue      # analytically zero (key and positional biases)
        compared += 1
        assert _rel(gk[name], gp[name]) <= 2e-3, name
    assert compared > 0.8 * len(gp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 1e-4, 5e-4),
                                            (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("drop,residual", [(0.0, False), (0.1, False),
                                           (0.1, True)])
@pytest.mark.parametrize("b,t,d,heads,lengths", [
    (16, 151, 256, 4, [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33,
                       17, 2, 1, 0]),        # audio stage 1 / video stage 0
    (16, 76, 360, 4, [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2,
                      1, 0]),                # the 360-wide stages, d_head 90
    (3, 37, 20, 2, [37, 0, 5]),              # no multiple of any tile
    (2, 70, 24, 4, None),                    # no lengths, two query tiles
    (4, 200, 256, 4, [200, 130, 1, 0]),      # 4 query tiles, the last ragged
    (4, 99, 180, 4, [99, 50, 1, 0]),         # d_head 45 (the 180-wide stage)
    (2, 330, 32, 2, [330, 3]),               # six key tiles
    (1, 740, 32, 2, [740]),                  # past the tensor-core stages' 736
])
def test_attention_module_kernels_match_plain(cuda_device, dtype, tol, wtol,
                                              drop, residual, b, t, d, heads,
                                              lengths):
    x, g, params = _att_inputs(cuda_device, dtype, b, t, d)
    lens = None if lengths is None else torch.tensor(lengths,
                                                     device=cuda_device)
    leaves = [x] + params
    outs, grads = [], []
    for use_kernel in (True, False):
        for a in leaves:
            a.requires_grad_(True)
            a.grad = None
        n0 = dict(_cuda.launches)
        y = fused_attention_module_3d(
            x, *params, num_heads=heads, lengths=lens, seed=99,
            drop_rate=drop, deterministic=False, residual=residual,
            use_kernel=use_kernel)
        y.backward(g)
        torch.cuda.synchronize()
        for name in ("fused_att_fwd", "fused_att_bwd"):
            assert _cuda.launches[name] - n0.get(name, 0) == int(use_kernel)
        outs.append(y.detach())
        grads.append([a.grad.clone() for a in leaves])
    assert outs[0].dtype == dtype and grads[0][0].dtype == dtype
    assert _rel(outs[0], outs[1]) <= tol
    if drop and not residual:
        # exactly the hash mask's entries are dropped (in bf16 about one kept
        # entry in a thousand also cancels to zero against its bias)
        dropped = dropout_mask(99, b * t, d, 1, 1.0 - drop, cuda_device,
                               tile_rows=t).reshape(b, t, d) == 0
        for y in outs:
            assert bool((y[dropped] == 0).all())
            assert float((y[~dropped] == 0).float().mean()) < 5e-3
    gmax = max(float(a.float().abs().max()) for a in grads[1][1:])
    for name, got, want in zip(ATT_NAMES, *grads):
        if name != "x":
            assert got.dtype == torch.float32
        if float(want.float().abs().max()) <= 1e-6 * gmax:
            continue          # the key bias: analytically zero, noise only
        assert _rel(got, want) <= (tol if name == "x" and dtype
                                   == torch.bfloat16 else wtol), name


@pytest.mark.cuda
def test_attention_module_bf16_backward_is_deterministic(cuda_device):
    """The bf16 backward has one owner per gradient element and sums in a
    fixed order (no atomics): two calls give the same bits."""
    x, g, params = _att_inputs(cuda_device, torch.bfloat16, 16, 151, 256)
    lens = torch.tensor([151, 120, 77, 1] * 4, device=cuda_device)
    runs = []
    for _ in range(2):
        leaves = [a.detach().requires_grad_(True) for a in [x] + params]
        fused_attention_module_3d(
            leaves[0], *leaves[1:], num_heads=4, lengths=lens, seed=99,
            drop_rate=0.1, deterministic=False).backward(g)
        runs.append([a.grad.clone() for a in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,heads,lengths", [
    (16, 151, 256, 4, [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33,
                       17, 2, 1, 0]),
    (16, 76, 360, 4, [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2,
                      1, 0]),
    (4, 99, 180, 4, [99, 50, 1, 0]),          # T, d and d_head 45 on no tile
])
def test_attention_module_bf16_forward_is_deterministic(cuda_device, b, t, d,
                                                        heads, lengths):
    """The bf16 forward has one owner per output element and no atomics:
    two calls give the same bits, with dropout and the residual, lengths
    down to 0."""
    x, _, params = _att_inputs(cuda_device, torch.bfloat16, b, t, d)
    lens = torch.tensor(lengths, device=cuda_device)
    n0 = _cuda.launches["fused_att_fwd"]
    with torch.no_grad():
        runs = [fused_attention_module_3d(
            x, *params, num_heads=heads, lengths=lens, seed=99, drop_rate=0.1,
            deterministic=False, residual=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert _cuda.launches["fused_att_fwd"] - n0 == 2
    assert runs[0].dtype == torch.bfloat16
    assert bool(torch.isfinite(runs[0].float()).all())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,heads,lengths", [
    (16, 151, 256, 4, [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33,
                       17, 2, 1, 0]),
    (16, 76, 360, 4, [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2,
                      1, 0]),
    (4, 200, 256, 4, [200, 130, 1, 0]),
    (2, 330, 32, 2, [330, 3]),
    (1, 740, 32, 2, [740]),                  # the FMA stages
])
def test_attention_module_bf16_backward_keeps_fp32_operands(
        cuda_device, b, t, d, heads, lengths):
    """The TPU kernel's backward multiplies dO = g Wo, the softmax, ds and
    the rel-pos cotangent unrounded; the bf16 backward keeps them at fp32's
    precision too, so its parameter gradients stay within 2e-3 of the plain
    version's largest entry (rounding those operands to bf16 passes that
    bound at the step's shapes)."""
    x, g, params = _att_inputs(cuda_device, torch.bfloat16, b, t, d)
    lens = torch.tensor(lengths, device=cuda_device)
    grads = []
    for use_kernel in (True, False):
        leaves = [a.detach().requires_grad_(True) for a in [x] + params]
        fused_attention_module_3d(
            leaves[0], *leaves[1:], num_heads=heads, lengths=lens, seed=99,
            drop_rate=0.1, deterministic=False, residual=False,
            use_kernel=use_kernel).backward(g)
        grads.append([a.grad for a in leaves[1:]])
    torch.cuda.synchronize()
    gmax = max(float(a.abs().max()) for a in grads[1])
    errs = {name: _rel(got, want)
            for name, got, want in zip(ATT_NAMES[1:], *grads)
            if float(want.abs().max()) > 1e-6 * gmax}
    assert max(errs.values()) <= 2e-3, errs


@pytest.mark.cuda
def test_attention_module_kernel_rejects_bad_inputs(cuda_device):
    x, _, params = _att_inputs(cuda_device, torch.float32, 2, 8, 16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fused_attention_module_3d(x.half(), *params, num_heads=2)
    with pytest.raises(ValueError, match="multiple of num_heads"):
        fused_attention_module_3d(x, *params, num_heads=3)
    with pytest.raises(ValueError, match="parameter shapes"):
        fused_attention_module_3d(x, *params[:2],
                                  params[2][:, :8].contiguous(), *params[3:],
                                  num_heads=2)
    with pytest.raises(ValueError, match="fp32 tensors"):
        fused_attention_module_3d(x, params[0].double(), *params[1:],
                                  num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t", [(torch.float32, 2, 6),
                                       (torch.bfloat16, 16, 151)])
def test_train_stem_kernel_route_matches_plain_route(cuda_device, dtype, b, t):
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(b, t, 88, 88, 1, generator=gen).to(cuda_device, dtype)
    w = (torch.randn(64, 1, 5, 7, 7, generator=gen)
         / 245 ** 0.5).to(cuda_device)
    bias = (0.1 * torch.randn(64, generator=gen)).to(cuda_device)
    scale = (1.0 + 0.1 * torch.randn(64, generator=gen)).to(cuda_device)
    bn_bias = (0.1 * torch.randn(64, generator=gen)).to(cuda_device)
    cot = torch.randn(b * t, 22, 22, 64, generator=gen).to(cuda_device, dtype)
    results = []
    for use_kernel in (True, False):
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (w, bias, scale, bn_bias)]
        n0 = _cuda.launches["bn_relu_pool"]
        pooled, mean, var = fused_stem_train(x, *leaves, 1e-5, use_kernel)
        pooled.backward(cot)
        torch.cuda.synchronize()
        assert _cuda.launches["bn_relu_pool"] - n0 == int(use_kernel)
        results.append((pooled.detach(), mean, var, [a.grad for a in leaves]))
    (pk, mk, vk, gk), (pp, mp, vp, gp) = results
    exact = dtype == torch.bfloat16
    assert pk.shape == (b * t, 22, 22, 64) and pk.dtype == dtype
    assert _err(pk, pp) <= (0.0 if exact else 1e-5)
    assert _err(mk, mp) <= 1e-5 and _err(vk, vp) <= 1e-5
    assert float(gk[1].abs().max()) == 0.0 and float(gp[1].abs().max()) == 0.0
    for got, want in zip((gk[0], gk[2], gk[3]), (gp[0], gp[2], gp[3])):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= (1e-2 if exact else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 1e-4, 5e-4),
                                            (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("padding,drop", [("same", 0.0), ("same", 0.1),
                                          ("causal", 0.1)])
@pytest.mark.parametrize("b,t,d,e,k", [
    (16, 301, 180, 180, 15),     # audio stage 0
    (16, 151, 256, 256, 15),     # audio stage 1 / video stage 0
    (16, 76, 360, 360, 15),      # audio stage 2, video stage 1, fusion
    (3, 37, 20, 24, 5),          # d != E, no multiple of any tile
    (2, 70, 48, 96, 8),          # even k, two row tiles per sequence
])
def test_conv_module_kernels_match_plain(cuda_device, dtype, tol, wtol,
                                         padding, drop, b, t, d, e, k):
    x, g, params = _conv_inputs(cuda_device, dtype, b, t, d, e, k)
    results = []
    for use_kernel in (True, False):
        n0 = dict(_cuda.launches)
        results.append(_conv_run(x, g, params, padding, drop, use_kernel))
        torch.cuda.synchronize()
        for name in CONV_KERNELS:
            assert _cuda.launches[name] - n0.get(name, 0) == int(use_kernel)
    (outs, grads), (want_outs, want_grads) = results
    assert outs[0].dtype == dtype and grads[0].dtype == dtype
    for name, got, want in zip(("y", "mean", "var"), outs, want_outs):
        assert _rel(got, want) <= tol, name
    if drop:
        dropped = dropout_mask(99, b * t, e, 1, 1.0 - drop, cuda_device,
                               tile_rows=t).reshape(b, t, e) == 0
        for y in (outs[0], want_outs[0]):
            assert bool((y[dropped] == 0).all())
            assert float((y[~dropped] == 0).float().mean()) < 5e-3
    for name, got, want in zip(("x",) + CONV_PARAMS, grads, want_grads):
        if name == "dw_b":
            assert not got.abs().any() and not want.abs().any()
            continue
        if name != "x":
            assert got.dtype == torch.float32
        assert _rel(got, want) <= (tol if name == "x" and dtype
                                   == torch.bfloat16 else wtol), name


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["stats", "fwd", "bwd1", "bwd2"])
@pytest.mark.parametrize("b,t,d,e,k", [(16, 301, 180, 180, 15),
                                       (3, 37, 20, 24, 5)])
def test_conv_module_bf16_bwd2_is_deterministic(cuda_device, stage, b, t, d,
                                                e, k):
    """The stats pass and both bf16 backward passes sum without atomics
    (per-block partial sums added once in a fixed order), and the bf16
    forward has one owner per element of y: from the same inputs two calls
    give the same bits, with dropout: s1 and s2 (two fresh calls); y; the
    first pass's dW2, db2, r1 and r2; the second pass's dx and the five
    gradients it writes (from the batch statistics and one first pass's
    r1 / n, r2 / n)."""
    x, g, params = _conv_inputs(cuda_device, torch.bfloat16, b, t, d, e, k)
    call = conv_module._Launch(x, params, 99, conv_module.pad_lo_for("same", k),
                               1e-6, 0.1)
    mean, _, rstd = batch_stats(*call.stats(), b * t, 1e-5)
    if stage == "stats":
        names = ("s1", "s2")
        runs = [call.stats() for _ in range(2)]
    elif stage == "fwd":
        names = ("y",)
        runs = [(call.fwd(mean, rstd),) for _ in range(2)]
    elif stage == "bwd1":
        names = ("pw2_w", "pw2_b", "r1", "r2")
        runs = [call.bwd1(g, mean, rstd) for _ in range(2)]
    else:
        names = ("x", "ln_w", "ln_b", "pw1_w", "pw1_b", "dw_w")
        _, _, r1, r2 = call.bwd1(g, mean, rstd)
        runs = [call.bwd2(g, mean, rstd, r1 / (b * t), r2 / (b * t))
                for _ in range(2)]
    torch.cuda.synchronize()
    for name, first, second in zip(names, *runs):
        assert torch.equal(first, second), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,d,e,k", [
    (torch.float32, 16, 301, 180, 180, 15),
    (torch.float32, 3, 29, 17, 21, 7),
    (torch.bfloat16, 3, 29, 17, 21, 7),
])
def test_conv_module_stats_is_deterministic(cuda_device, dtype, b, t, d, e,
                                            k):
    """In both types the stats pass writes one partial sum per row tile and
    channel and adds them in a fixed order: two calls give the same s1 and
    s2, at the step's widths and at odd ones (bf16 at the step's widths:
    the "stats" case of the test above)."""
    x, _, params = _conv_inputs(cuda_device, dtype, b, t, d, e, k)
    call = conv_module._Launch(x, params, 99, conv_module.pad_lo_for("same", k),
                               1e-6, 0.0)
    runs = [call.stats() for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 1e-4, 5e-4),
                                            (torch.bfloat16, 2e-2, 3e-2)])
def test_conv_module_kernels_match_plain_at_odd_widths(cuda_device, dtype, tol,
                                                       wtol):
    """Odd d and E: the depthwise stencil stages its window one element at a
    time (no 16-byte or pair loads), and the row tiles straddle sequences."""
    b, t, d, e, k = 3, 29, 17, 21, 7
    x, g, params = _conv_inputs(cuda_device, dtype, b, t, d, e, k)
    (outs, grads), (want_outs, want_grads) = (
        _conv_run(x, g, params, "same", 0.1, use_kernel)
        for use_kernel in (True, False))
    for name, got, want in zip(("y", "mean", "var"), outs, want_outs):
        assert _rel(got, want) <= tol, name
    for name, got, want in zip(("x",) + CONV_PARAMS, grads, want_grads):
        if name != "dw_b":
            assert _rel(got, want) <= (tol if name == "x" and dtype
                                       == torch.bfloat16 else wtol), name


@pytest.mark.cuda
def test_conv_module_kernel_rejects_bad_inputs(cuda_device):
    x, _, params = _conv_inputs(cuda_device, torch.float32, 2, 8, 16, 16, 5)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fused_conv_module_3d(x.half(), *params)
    with pytest.raises(ValueError, match="parameter shapes"):
        fused_conv_module_3d(x, *params[:2], params[2][:, :8].contiguous(),
                             *params[3:])
    with pytest.raises(ValueError, match="fp32 tensors"):
        fused_conv_module_3d(x, params[0].double(), *params[1:])
    with pytest.raises(ValueError, match="outside the kernels' range"):
        xw, _, pw = _conv_inputs(cuda_device, torch.float32, 1, 4, 400, 8, 5)
        fused_conv_module_3d(xw, *pw)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        xk, _, pk = _conv_inputs(cuda_device, torch.float32, 1, 40, 8, 8, 33)
        fused_conv_module_3d(xk, *pk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 1e-4, 5e-4),
                                            (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("b,t,d,e,k,padding", [
    (16, 151, 256, 256, 15, "same"),     # audio stage 1 / video stage 0
    (4, 37, 20, 24, 5, "causal"),        # d != E, no multiple of any tile
])
def test_conv_module_dp_kernels_on_two_ranks_match_one_call(
        cuda_device, dtype, tol, wtol, b, t, d, e, k, padding):
    """K3dp: two gloo ranks on one card, each running the four passes on half
    of the batch with the statistics all-reduced between them, against the
    single-process K3/K3b call on the whole batch (dropout 0): y and dx
    concatenated, mean and var, the parameter gradients summed over the
    ranks; each rank launches each pass once, under the K3dp names."""
    from avec_tpu_torch.parallel.dist import spawn
    from test_torch_parallel import module_dp_rank

    _cuda.build()                     # once, before the ranks load it
    x, g, params = _conv_inputs("cpu", torch.float32, b, t, d, e, k)
    x, g = x.to(dtype).float(), g.to(dtype).float()   # exact in dtype
    ranks = spawn(module_dp_rank, 2, "gloo", "cuda:0", "conv", x.numpy(),
                  g.numpy(), [p.numpy() for p in params],
                  {"padding": padding, "drop_rate": 0.0},
                  str(dtype).split(".")[1])
    outs, grads = _conv_run(x.to(cuda_device, dtype), g.to(cuda_device, dtype),
                            [p.to(cuda_device) for p in params], padding, 0.0,
                            True)
    for r in ranks:
        assert r[2] == {f"fused_conv_dp_{p}": 1
                        for p in ("stats", "fwd", "bwd1", "bwd2")}
    got_outs = [np.concatenate([r[0][0] for r in ranks])] + ranks[0][0][1:]
    got_grads = [np.concatenate([r[1][0] for r in ranks])]
    got_grads += [sum(r[1][i] for r in ranks) for i in range(1, 11)]
    for name, got, want in zip(("y", "mean", "var"), got_outs, outs):
        assert _rel(torch.from_numpy(got), want.cpu()) <= tol, name
    for name, got, want in zip(("x",) + CONV_PARAMS, got_grads, grads):
        if name == "dw_b":
            assert not np.abs(got).any()
            continue
        lim = tol if name == "x" and dtype == torch.bfloat16 else wtol
        assert _rel(torch.from_numpy(got), want.cpu()) <= lim, name
