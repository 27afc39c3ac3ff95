"""The port's CUDA kernels (fused FFN K1/K1b, flash attention K4 and its
backward K4b, stem K5) against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where JAX
is absent. On a machine with an NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q

Tests marked `cuda` decide inside a fixture whether a card is present and
skip without one; the others run on the CPU, where each wrapper computes its
plain version. Tolerances: fp32 max abs 1e-4; flash bf16 2e-2 (bf16 inputs,
fp32 accumulation in both); stem bf16 exact (a max of identically rounded
values); whole-model fp32 logits 2e-3. FFN: fp32 1e-4 for y and dx and 3e-4
of the largest entry for the parameter gradients (atomic sums over all rows);
bf16 2e-2 / 3e-2 of the largest entry. Flash backward: fp32 1e-4, bf16 3e-2
of the largest entry.
"""

import numpy as np
import pytest
import torch

from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.ffn import (dropout_mask, fused_ffn,
                                    fused_ffn_reference)
from avec_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_bwd_reference,
                                                flash_attention_fwd,
                                                flash_attention_reference)
from avec_tpu_torch.ops.stem import bn_relu_pool, bn_relu_pool_reference

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
    dout = torch.randn_like(v)
    delta = (dout * out).sum(-1).reshape(lse.shape)
    for a, b in zip(flash_attention_bwd(q, k, v, dout, lse, delta, lens, 0.5),
                    flash_attention_bwd_reference(q, k, v, dout, lse, delta,
                                                  lens, 0.5)):
        assert torch.equal(a, b)
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
                                  "flash_attention", "stem"])
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
def test_stem_kernel_matches_plain(cuda_device, dtype, tol):
    gen = torch.Generator().manual_seed(1)
    y = torch.randn(37, 44, 44, 64, generator=gen).to(cuda_device, dtype)
    a = (torch.rand(64, generator=gen) + 0.5).to(cuda_device)
    b = (torch.randn(64, generator=gen) * 0.2).to(cuda_device)
    n0 = _cuda.launches["bn_relu_pool"]
    got = bn_relu_pool(y, a, b)
    torch.cuda.synchronize()
    assert _cuda.launches["bn_relu_pool"] == n0 + 1
    assert got.shape == (37, 22, 22, 64) and got.dtype == dtype
    assert _err(got, bn_relu_pool_reference(y, a, b)) <= tol


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
    (77, 20, 70),            # no multiple of any tile
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
    assert _rel(outs[0], outs[1]) <= tol
    assert _rel(got_grads[0], want_grads[0]) <= tol
    for got, want in zip(got_grads[1:], want_grads[1:]):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= wtol


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
                      f_interctc_blocks=(1,), use_flash=True)
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
