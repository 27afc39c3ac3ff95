"""Training-mode BatchNorm (`ops/batch_norm.py`, `csrc/batch_norm.cu`): the
plain entry points against `ops/layers.py:BatchNorm`'s own arithmetic on the
CPU, the routing of `BatchNorm` and of the ResNet blocks, and on the card the
kernels against the plain entry points.

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batch_norm.py -m cuda -q

On the CPU `in_scope` is patched to admit CPU tensors, so `BatchNorm` and the
ResNet blocks take the autograd function over the plain entry points (the
route a CUDA tensor takes through the kernels, `use_kernel` on): its
output equals the plain module's bit for bit, its gradients within 1e-5 of
the largest entry in fp32 (autograd's derivation and the closed form round
differently) and one bf16 step of the largest entry in bf16 (the two fp32
results round to neighbouring bf16 values). The plain statistics add their
sums in the kernel's order (`sums_reference`): on any data whose sums are
exact they equal the exact sums. On the card: the statistics bit for bit
(the same adds in the same order), the backward's sums within 1e-5 of the
largest entry (another order), apply and bwd-dx bit for bit given the same
statistics (the same separately rounded steps), the same bits over two
calls.
"""

import contextlib
import copy

import pytest
import torch
import torch.nn.functional as F

from avec_tpu_torch.models.resnet import (ResNet, ResNetBlock,
                                          ResNetBottleneckBlock)
from avec_tpu_torch.ops import _cuda, batch_norm
from avec_tpu_torch.ops import layers as layers_mod
from avec_tpu_torch.ops.layers import BatchNorm, running_statistics_held

torch.set_num_threads(1)

LAYOUTS = ("nchw", "channels_last", "bct", "btc_view", "rows", "ncdhw",
           "strided")


def _tensor(layout, dtype, gen, n=4, c=8, h=5, w=6):
    """A tensor with channels on axis 1 in `layout`."""
    if layout in ("nchw", "channels_last"):
        x = torch.randn(n, c, h, w, generator=gen).to(dtype)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        return x
    if layout == "bct":
        return torch.randn(n, c, h * w, generator=gen).to(dtype)
    if layout == "rows":
        return torch.randn(n * h * w, c, generator=gen).to(dtype)
    if layout == "ncdhw":
        return torch.randn(n, c, 2, h, w // 2, generator=gen).to(dtype)
    if layout == "strided":                   # neither layout: made contiguous
        return torch.randn(n, c, h, 2 * w, generator=gen).to(dtype)[..., ::2]
    return torch.randn(n, h * w, c, generator=gen).to(dtype).transpose(1, 2)


def _like(x, gen):
    return torch.empty_like(x).copy_(torch.randn(x.shape, generator=gen))


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def _rel2(a, b) -> float:
    """|a - b| over |b|, in the L2 norm."""
    return float((a.double() - b.double()).norm()) / max(
        float(b.double().norm()), 1e-30)


def _tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 2.0 ** -7


@contextlib.contextmanager
def _cpu_in_scope(monkeypatch):
    """Inside, BatchNorm takes the kernels' route for CPU tensors too (where
    the entry points compute their plain versions)."""
    with monkeypatch.context() as mp:
        mp.setattr(batch_norm, "in_scope", lambda x: True)
        yield


def _bn(c, gen):
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
    return bn.train()


def _run(bn, x, g, residual, relu):
    """Output and gradients of x, weight, bias (and residual)."""
    for p in bn.parameters():
        p.grad = None
    xa = x.detach().clone().requires_grad_(True)
    ra = (None if residual is None
          else residual.detach().clone().requires_grad_(True))
    y = bn(xa, residual=ra, relu=relu)
    y.backward(g)
    grads = [xa.grad, bn.weight.grad.clone(), bn.bias.grad.clone()]
    return y.detach(), grads + ([] if ra is None else [ra.grad])


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_entry_points_match_batch_norm(monkeypatch, layout, dtype,
                                             residual, relu):
    """The autograd function over the plain entry points against the
    plain module: the same output bits, gradients of x, weight, bias and
    the residual, the same running statistics, the output in x's layout
    (contiguous where x is in neither layout the kernels view)."""
    gen = torch.Generator().manual_seed(0)
    x = _tensor(layout, dtype, gen)
    g = _like(x, gen)
    res = _like(x, gen) if residual else None
    plain, fused = _bn(8, gen), BatchNorm(8).train()
    fused.load_state_dict(plain.state_dict())
    want_y, want = _run(plain, x, g, res, relu)
    with _cpu_in_scope(monkeypatch):
        got_y, got = _run(fused, x, g, res, relu)
    kept = x if batch_norm.layout(x) is not None else x.contiguous()
    assert got_y.dtype == dtype and got_y.stride() == kept.stride()
    assert torch.equal(got_y, want_y)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a, b) <= _tol(dtype)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(fused, name), getattr(plain, name))


@pytest.mark.parametrize("layout,want", [
    ("nchw", (4, 8, 30)), ("channels_last", (120, 8, 1)),
    ("bct", (4, 8, 30)), ("btc_view", (120, 8, 1))])
def test_layout_views(layout, want):
    x = _tensor(layout, torch.float32, torch.Generator().manual_seed(0))
    assert batch_norm.layout(x) == want
    assert batch_norm.layout(torch.zeros(7, 64)) == (7, 64, 1)
    assert batch_norm.layout(x[:, :, 1:]) is None        # neither layout
    assert batch_norm.layout(torch.zeros(0, 8, 3)) is None
    assert not batch_norm.in_scope(x)                     # a CPU tensor
    n = batch_norm.splits(*want)
    assert 1 <= n <= 1024 and n == batch_norm.splits(*want)


def _sums_case(case):
    """A tensor of the stats kernel's every walk: rows and planes, 16 bytes
    a thread or one value (C or inner no multiple of the width, or an
    unaligned pointer), several rows or vectors a thread and several
    partials a finishing thread."""
    gen = torch.Generator().manual_seed(11)
    shapes = {"rows_bf16": ((40000, 64), torch.bfloat16),
              "rows_fp32": ((40000, 64), torch.float32),
              "rows_one_value": ((40000, 6), torch.bfloat16),
              "channels_last": ((100, 16, 20, 20), torch.bfloat16),
              "planes_bf16": ((128, 8, 4096), torch.bfloat16),
              "planes_fp32": ((64, 8, 4096), torch.float32),
              "planes_one_value": ((64, 8, 4100), torch.bfloat16),
              "unaligned": ((40000, 64), torch.bfloat16)}
    shape, dtype = shapes[case]
    n = int(torch.tensor(shape).prod())
    flat = torch.randint(-4, 5, (n + 1,), generator=gen).to(dtype)
    if case == "unaligned":
        return flat[1:].view(shape)
    x = flat[:n].view(shape)
    if case == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    return x


@pytest.mark.parametrize("case", ["rows_bf16", "rows_fp32", "rows_one_value",
                                  "channels_last", "planes_bf16",
                                  "planes_fp32", "planes_one_value",
                                  "unaligned"])
def test_plain_statistics_add_every_term_once(case):
    """`sums_reference` (the stats kernel's order) on integers, whose sums
    fp32 holds exactly in any order, equals the exact sums; and on normal
    data the statistics are within 1e-6 of float64's."""
    x = _sums_case(case)
    lay = batch_norm.layout(x)
    width = batch_norm._width(x, lay[1], lay[2])
    assert width == (1 if "one_value" in case or case == "unaligned"
                     else 16 // x.element_size())
    assert batch_norm.splits(*lay) > batch_norm._FINISH_ROWS
    s1, s2 = batch_norm.sums_reference(x)
    axes = (0,) + tuple(range(2, x.ndim))
    xd = x.double()
    assert torch.equal(s1.double(), xd.sum(dim=axes))
    assert torch.equal(s2.double(), (xd * xd).sum(dim=axes))
    xn = torch.empty_like(x).copy_(
        torch.randn(x.shape, generator=torch.Generator().manual_seed(12)))
    st = batch_norm.stats_reference(xn, 1e-5)
    xd = xn.double()
    mean = xd.mean(dim=axes)
    var = xd.var(dim=axes, unbiased=False)
    for got, want in ((st[0], mean), (st[1], var),
                      (st[2], (var + 1e-5).rsqrt())):
        assert float((got.double() - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_running_statistics_held_leaves_running_alone(monkeypatch, route):
    gen = torch.Generator().manual_seed(1)
    bn, x = _bn(8, gen), _tensor("channels_last", torch.bfloat16, gen)
    before = [bn.running_mean.clone(), bn.running_var.clone()]
    with contextlib.ExitStack() as stack:
        if route == "kernels":
            stack.enter_context(_cpu_in_scope(monkeypatch))
        with running_statistics_held():
            bn(x, relu=True)
        assert torch.equal(bn.running_mean, before[0])
        assert torch.equal(bn.running_var, before[1])
        bn(x, relu=True)
        assert not torch.equal(bn.running_mean, before[0])


@pytest.mark.parametrize("mode", ["train", "eval", "frozen", "process_group",
                                  "use_kernel_off"])
def test_eval_frozen_and_sync_bn_keep_the_plain_path(monkeypatch, mode):
    """Only a training BatchNorm with its own batch statistics, no process
    group and `use_kernel` on (`set_kernels(False)` turns it off) calls the
    kernels' function."""
    calls = []

    def record(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    orig = batch_norm.batch_norm_train
    monkeypatch.setattr(batch_norm, "batch_norm_train", record)
    monkeypatch.setattr(layers_mod, "sync_moments",
                        lambda mean, ex2, n, group: (mean, ex2, n))
    gen = torch.Generator().manual_seed(2)
    bn, x = _bn(8, gen), _tensor("nchw", torch.float32, gen)
    if mode == "eval":
        bn.eval()
    bn.frozen = mode == "frozen"
    bn.process_group = object() if mode == "process_group" else None
    bn.use_kernel = mode != "use_kernel_off"
    with _cpu_in_scope(monkeypatch):
        y = bn(x, relu=True)
    assert len(calls) == int(mode == "train")
    assert float(y.detach().min()) >= 0.0


def _block(kind):
    if kind == "basic":
        return ResNetBlock(16, 32, 2), (2, 16, 9, 9)
    if kind == "basic_identity_pre_add_act":
        return ResNetBlock(16, 16, 1, joined_post_act=False), (2, 16, 7, 7)
    if kind == "bottleneck":
        return ResNetBottleneckBlock(16, 32, 2, 2), (2, 16, 9, 9)
    if kind == "swish":
        return ResNetBlock(16, 32, 2, act_fun="Swish"), (2, 16, 9, 9)
    return (ResNet("ResNet18", dim_output=10, in_channels=3),
            (4, 3, 64, 64))


def _init(module, gen):
    """Parameters drawn from `gen`: fp32, BatchNorm scales about 1."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan = p[0].numel() if p.ndim > 1 else 1
            p.copy_(torch.randn(p.shape, generator=gen) / fan ** 0.5
                    * (0.1 if p.ndim == 1 else 1.0)
                    + (1.0 if p.ndim == 1 and "weight" in name else 0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["basic", "basic_identity_pre_add_act",
                                  "bottleneck", "swish", "resnet18_stem"])
def test_resnet_blocks_route_their_batch_norms_like_the_plain_path(
        monkeypatch, kind, dtype):
    """A ResNet block (or ResNet18 with its stem) training on channels-last
    input through the kernels' function equals the same block on the plain
    path: output bits, running statistics, and in fp32 the input and
    parameter gradients within 1e-4 of their largest entries. In bf16 each
    route rounds every backward step to bf16, the two differently (the
    closed form against autograd's derivation), so there each gradient is
    held to the fp32 plain step on the same (bf16) input: the kernels'
    route within 1.25 times the plain route's distance (relative L2)."""
    gen = torch.Generator().manual_seed(3)
    block, shape = _block(kind)
    _init(block, gen)
    block.train()
    x = torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    start = {k: v.clone() for k, v in block.state_dict().items()}
    runs, calls, cot = {}, [], None
    orig = batch_norm.batch_norm_train

    def record(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    routes = ("plain", "kernels") + (("fp32",) if dtype != torch.float32
                                     else ())
    for route in routes:
        block.load_state_dict(start)
        block.zero_grad(set_to_none=True)
        dt = torch.float32 if route == "fp32" else dtype
        with contextlib.ExitStack() as stack:
            if route == "kernels":
                stack.enter_context(_cpu_in_scope(monkeypatch))
            stack.enter_context(monkeypatch.context()).setattr(
                batch_norm, "batch_norm_train", record)
            xa = x.detach().clone().to(dt).requires_grad_(True)
            y = block(xa)
            if cot is None:
                cot = 1.0 + 0.1 * torch.randn(
                    y.shape, generator=torch.Generator().manual_seed(5))
            y.backward(cot.to(dt))
        assert len(calls) == (sum(isinstance(m, BatchNorm)
                                  for m in block.modules())
                              if route == "kernels" else 0)
        calls.clear()
        runs[route] = (y.detach(), {"x": xa.grad, **{
            k: p.grad for k, p in block.named_parameters()}},
            {k: v.clone() for k, v in block.state_dict().items()
             if "running" in k})
    (yp, gp, sp), (yk, gk, sk) = runs["plain"], runs["kernels"]
    assert torch.equal(yk, yp)
    for name in sp:
        assert torch.equal(sk[name], sp[name]), name
    for name in gp:
        if dtype == torch.float32:
            assert _rel(gk[name], gp[name]) <= 1e-4, name
        else:
            want = runs["fp32"][1][name]
            assert _rel2(gk[name], want) <= 1.25 * _rel2(gp[name], want) \
                + 1e-6, name


def _zoo_model(kind, fused, stem_mode):
    from avec_tpu_torch.models import zoo

    route = dict(fused_ffn=fused, fused_att=fused, fused_conv=fused,
                 device="cpu")
    if kind in ("ao", "causal"):
        extra = dict(causal=True, left_context=16) if kind == "causal" else {}
        return zoo.AudioEfficientConformerInterCTC(
            vocab_size=16, num_blocks=(2, 2, 1), interctc_blocks=(2,),
            **extra, **route)
    if kind == "vo":
        return zoo.VisualEfficientConformerInterCTC(
            vocab_size=16, num_blocks=(2, 1), interctc_blocks=(1,),
            stem_mode=stem_mode, **route)
    return zoo.AudioVisualEfficientConformerInterCTC(
        vocab_size=16, v_num_blocks=(1, 1), a_num_blocks=(1, 1, 1),
        f_num_blocks=1, v_interctc_blocks=(1,), a_interctc_blocks=(1,),
        f_interctc_blocks=(1,), stem_mode=stem_mode, **route)


@pytest.mark.parametrize("kind,fused,stem_mode", [
    (kind, fused, stem) for kind in ("av", "vo") for fused in (False, True)
    for stem in ("pallas", "2d")] + [
    (kind, fused, None) for kind in ("ao", "causal") for fused in (False, True)])
def test_launch_counts_follow_the_batch_norms_a_step_calls(
        monkeypatch, kind, fused, stem_mode):
    """`kernel_launches_per_step` counts, from the module tree, as many
    BatchNorm calls as a training forward makes through the kernels'
    function, plus the "pallas" stem's statistics and backward; after
    `set_kernels(False)` a forward makes none."""
    torch.manual_seed(0)
    model = _zoo_model(kind, fused, stem_mode).train()
    calls = []
    orig = batch_norm.batch_norm_train

    def record(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    gen = torch.Generator().manual_seed(7)
    audio = (0.1 * torch.randn(2, 3200, generator=gen),
             torch.tensor([3200, 2800], dtype=torch.int32))
    video = (torch.rand(2, 5, 88, 88, 1, generator=gen),
             torch.tensor([5, 4], dtype=torch.int32))
    inputs = {"av": video + audio, "vo": video}.get(kind, audio)
    with _cpu_in_scope(monkeypatch):
        monkeypatch.setattr(batch_norm, "batch_norm_train", record)
        model(*inputs)
    per_step = model.kernel_launches_per_step()
    stems = int(kind in ("av", "vo") and stem_mode == "pallas")
    assert {k: per_step.get(k, 0) for k in batch_norm.KERNELS} == \
        batch_norm.launches(len(calls), stems)
    assert len(calls) >= (19 if kind in ("av", "vo") else 1)
    n_calls = len(calls)
    model.set_kernels(False)
    with _cpu_in_scope(monkeypatch):
        monkeypatch.setattr(batch_norm, "batch_norm_train", record)
        model(*inputs)
    assert len(calls) == n_calls


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_tensor(shape, dtype, device, layout, seed):
    gen = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=gen)
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    t = t.to(device, dtype)
    return t


CARD_SHAPES = [
    ((256, 64, 22, 22), "channels_last"),    # trunk stage 1, 256 frames
    ((256, 512, 3, 3), "channels_last"),     # trunk stage 4
    ((32 * 44 * 44, 64), "rows"),            # the stem's (rows, 64)
    ((8, 180, 40, 101), "nchw"),             # an audio stem, planes of 4040
    ((6, 37, 13), "nchw"),                   # odd planes: one value a thread
    ((50, 180, 3, 3), "channels_last"),      # C no multiple of 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,layout", CARD_SHAPES)
def test_kernels_match_plain(cuda_device, shape, layout, dtype, residual,
                             relu):
    c = shape[1]
    x = _card_tensor(shape, dtype, cuda_device, layout, 0) * 2.0 + 0.5
    g = _card_tensor(shape, dtype, cuda_device, layout, 1)
    res = _card_tensor(shape, dtype, cuda_device, layout, 2) if residual \
        else None
    w = (1.0 + 0.1 * torch.randn(c, generator=torch.Generator()
                                 .manual_seed(3))).to(cuda_device)
    b = (0.1 * torch.randn(c, generator=torch.Generator()
                           .manual_seed(4))).to(cuda_device)
    n0 = dict(_cuda.launches)
    st = batch_norm.stats(x, 1e-5)
    assert torch.equal(st, batch_norm.stats_reference(x, 1e-5))
    y = batch_norm.apply(x, st, w, b, res, relu)
    assert y.dtype == dtype and y.stride() == x.stride()
    assert torch.equal(y, batch_norm.apply_reference(x, st, w, b, res, relu))
    gate = y if relu else None
    red = batch_norm.bwd_reduce(g, x, gate, st, w)
    want_red = batch_norm.bwd_reduce_reference(g, x, gate, st, w)
    for i in range(5):
        assert _rel(red[i], want_red[i]) <= 1e-5, i
    dx, gres = batch_norm.bwd_dx(g, x, gate, st, red, write_g=residual)
    want_dx, want_g = batch_norm.bwd_dx_reference(g, x, gate, st, red,
                                                  write_g=residual)
    assert dx.stride() == x.stride() and torch.equal(dx, want_dx)
    assert (gres is None) == (not residual)
    if residual:
        assert torch.equal(gres, want_g)
    torch.cuda.synchronize()
    assert {k: _cuda.launches[k] - n0.get(k, 0)
            for k in batch_norm.KERNELS} == dict.fromkeys(batch_norm.KERNELS,
                                                          1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", CARD_SHAPES[:3])
def test_kernels_give_the_same_bits_on_two_calls(cuda_device, shape, layout):
    x = _card_tensor(shape, torch.bfloat16, cuda_device, layout, 0)
    g = _card_tensor(shape, torch.bfloat16, cuda_device, layout, 1)
    w = torch.ones(shape[1], device=cuda_device)
    b = torch.zeros(shape[1], device=cuda_device)
    st = [batch_norm.stats(x, 1e-5) for _ in range(2)]
    assert torch.equal(st[0], st[1])
    y = batch_norm.apply(x, st[0], w, b, None, True)
    red = [batch_norm.bwd_reduce(g, x, y, st[0], w) for _ in range(2)]
    assert torch.equal(red[0], red[1])
    dx = [batch_norm.bwd_dx(g, x, y, st[0], red[0])[0] for _ in range(2)]
    assert torch.equal(dx[0], dx[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bns", [("basic", 3), ("bottleneck", 4),
                                      ("basic_identity_pre_add_act", 2)])
def test_block_launches_per_forward_and_backward(cuda_device, kind, bns):
    """Each BatchNorm of a block launches stats + apply forward and
    bwd-reduce + bwd-dx backward, once each."""
    block, shape = _block(kind)
    _init(block, torch.Generator().manual_seed(3))
    block = block.to(cuda_device).train()
    x = torch.randn(shape, device=cuda_device, dtype=torch.bfloat16
                    ).contiguous(memory_format=torch.channels_last)
    xa = x.requires_grad_(True)
    n0 = dict(_cuda.launches)
    y = block(xa)
    fwd = {k: _cuda.launches[k] - n0.get(k, 0) for k in batch_norm.KERNELS}
    y.float().sum().backward()
    torch.cuda.synchronize()
    both = {k: _cuda.launches[k] - n0.get(k, 0) for k in batch_norm.KERNELS}
    assert fwd == {"bn_stats": bns, "bn_apply": bns, "bn_bwd_reduce": 0,
                   "bn_bwd_dx": 0}
    assert both == dict.fromkeys(batch_norm.KERNELS, bns)


def _f64_forward(self, x, residual=None, relu=False):
    """BatchNorm.forward in float64 (cuDNN's), the truth of the fp32
    comparison below."""
    y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                     self.eps)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


@pytest.mark.cuda
def test_resnet18_train_step_launches_no_plain_batch_norm(cuda_device,
                                                          monkeypatch):
    """The AV front end's trunk (ResNet18 without its stem) trains on
    channels-last frames through the kernels alone: every plain entry point
    raises and 19 BatchNorms launch each kernel once; `use_kernel` off
    (`set_kernels(False)`) launches none. In fp32, for a random cotangent,
    its output and every gradient leaf are as close to the float64 step's
    as the plain path's: within twice their distance, or 2e-4 of the leaf's
    largest entry. The BatchNorm biases are 3, so that no ReLU input lies
    within rounding of 0: a gate that flips moves a leaf of this batch by
    percents, on either route. A bf16 step runs finite."""
    from avec_tpu_torch.ops.layers import init_params

    def refuse(*args, **kwargs):
        raise AssertionError("a plain BatchNorm entry point ran on the card")

    trunk = ResNet("ResNet18", dim_output=256, include_stem=False)
    init_params(trunk, torch.Generator().manual_seed(6))
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, BatchNorm):
                m.bias.fill_(3.0)
    trunk = trunk.to(cuda_device).train()
    gen = torch.Generator().manual_seed(7)
    frames = torch.randn(64, 22, 22, 64, generator=gen).to(cuda_device)
    cot = torch.randn(64, 256, generator=gen).to(cuda_device)

    def step(route, x):
        with monkeypatch.context() as mp:
            if route == "kernels":
                for name in ("stats_reference", "apply_reference",
                             "bwd_reduce_reference", "bwd_dx_reference"):
                    mp.setattr(batch_norm, name, refuse)
            if route == "f64":
                mp.setattr(BatchNorm, "forward", _f64_forward)
            model = copy.deepcopy(trunk).to(
                torch.float64 if route == "f64" else torch.float32)
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.use_kernel = route == "kernels"
            n0 = dict(_cuda.launches)
            y = model(x.permute(0, 3, 1, 2))       # channels-last NCHW
            (y * cot.to(y.dtype)).sum().backward()
            torch.cuda.synchronize()
            launched = {k: _cuda.launches[k] - n0.get(k, 0)
                        for k in batch_norm.KERNELS}
            assert launched == dict.fromkeys(
                batch_norm.KERNELS, 19 if route == "kernels" else 0)
            return y.detach(), {k: p.grad for k, p in model.named_parameters()}

    yk, gk = step("kernels", frames)
    yp, gp = step("plain", frames)
    y64, g64 = step("f64", frames.double())
    assert _rel(yk, y64) <= max(2 * _rel(yp, y64), 1e-6)
    err = {name: (_rel(gk[name], g64[name]), _rel(gp[name], g64[name]))
           for name in g64}
    assert all(k <= max(2 * p, 2e-4) for k, p in err.values()), err
    # bf16 activations, as the training step runs them
    y, _ = step("kernels", frames.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "ncdhw", "strided", "float16"])
def test_every_training_batch_norm_on_the_card_takes_the_kernels(
        cuda_device, layout):
    """A training BatchNorm of 2 or 5 axes, or of neither layout the
    kernels view, launches the kernels and equals the plain path's output;
    a float16 tensor, which the kernels do not take, raises."""
    gen = torch.Generator().manual_seed(9)
    if layout == "strided":                   # sliced on the card
        x = torch.randn(4, 8, 5, 12, generator=gen).to(cuda_device)[..., ::2]
        assert batch_norm.layout(x) is None
    else:
        x = _tensor("nchw" if layout == "float16" else layout, torch.float32,
                    gen).to(cuda_device)
    bn = _bn(8, torch.Generator().manual_seed(10)).to(cuda_device)
    if layout == "float16":
        with pytest.raises(ValueError, match="fp32 or bf16"):
            bn(x.half(), relu=True)
        return
    n0 = dict(_cuda.launches)
    y = bn(x, relu=True)
    torch.cuda.synchronize()
    assert {k: _cuda.launches[k] - n0.get(k, 0) for k in
            batch_norm.KERNELS} == {"bn_stats": 1, "bn_apply": 1,
                                    "bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    bn.use_kernel = False
    want = bn(x, relu=True)
    assert _rel(y, want) <= 1e-5
