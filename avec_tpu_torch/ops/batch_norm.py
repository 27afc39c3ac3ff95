"""Training-mode BatchNorm with batch statistics, as four hand-written CUDA
kernels (`csrc/batch_norm.cu`) with their plain PyTorch versions.

The entry points take x with its channels on axis 1, viewed as (outer, C,
inner): a contiguous tensor has inner = the product of the axes after the
channels (NCHW, (B, C, T); a contiguous (rows, C) has inner = 1), a tensor
whose channels are its innermost axis (channels-last) is rows of C
channels, inner = 1. Activations are bf16 or fp32, every sum is fp32 and
outputs are rounded to x's dtype, exactly as `ops/layers.py:BatchNorm`
computes them:

- `stats`: (3, C) fp32 rows mean, var = max(E[x^2] - mean^2, 0) and rstd =
  1 / sqrt(var + eps); its plain version adds the sums in the kernel's
  order (`sums_reference`), so the two give the same bits;
- `apply`: (x - mean) rstd w + b in fp32, rounded, plus an optional
  residual (rounded again) and an optional ReLU;
- `bwd_reduce`: (5, C) fp32 rows db = sum g', dw = sum g' xhat, w rstd,
  db / n, dw / n, where g' is the incoming gradient gated by the ReLU's
  output and xhat is recomputed from x;
- `bwd_dx`: dx = w rstd ((g' - db/n) - xhat dw/n), and g' for the residual
  branch where the ReLU gated it.

CPU tensors take the `*_reference` versions; a CUDA tensor launches the
kernel or raises (for a dtype other than bf16 and fp32). `batch_norm_train`
is the autograd function over them that `BatchNorm` calls for every CUDA
tensor it normalises with its batch's statistics: it saves x, the output
where a ReLU gates the gradient, and the statistics, 2 bytes an element in
bf16 (the output is the next layer's input, saved there anyway). A tensor
in neither layout is made contiguous first.
"""

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from avec_tpu_torch.ops import _cuda

KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
KERNEL_STATS, KERNEL_APPLY, KERNEL_BWD_REDUCE, KERNEL_BWD_DX = KERNELS
_DTYPES = (torch.float32, torch.bfloat16)
_BLOCKS = 1024      # about one wave of 256-thread blocks on 132 SMs
_THREADS = 256      # a block (csrc/batch_norm.cu)
_FINISH_ROWS = 64   # threads across partials in the finishing kernel


def launches(modules: int, stems: int = 0) -> Dict[str, int]:
    """The kernels' launches in one training forward and backward of
    `modules` BatchNorm modules (all four kernels each) and `stems` "pallas"
    video stems (the statistics and both backward kernels each)."""
    return {KERNEL_STATS: modules + stems, KERNEL_APPLY: modules,
            KERNEL_BWD_REDUCE: modules + stems, KERNEL_BWD_DX: modules + stems}


def _axes(x):
    return (0,) + tuple(range(2, x.ndim))


def _chan(v, x):
    """A (C,) vector shaped to broadcast over x's channel axis."""
    return v.view((1, -1) + (1,) * (x.ndim - 2))


def _channels_innermost(x) -> bool:
    if x.ndim == 4:
        return x.is_contiguous(memory_format=torch.channels_last)
    shape, stride, expect = x.shape, x.stride(), 1
    for d in (1,) + tuple(range(x.ndim - 1, 1, -1)) + (0,):
        if shape[d] != 1 and stride[d] != expect:
            return False
        expect *= shape[d]
    return True


def layout(x) -> Optional[Tuple[int, int, int]]:
    """(outer, C, inner) of x as the kernels view it, or None where x is
    neither contiguous nor channels-last (or has fewer than two axes or no
    elements)."""
    if x.ndim < 2 or x.numel() == 0:
        return None
    c = x.shape[1]
    if x.is_contiguous():
        return x.shape[0], c, x.numel() // (x.shape[0] * c)
    if _channels_innermost(x):
        return x.numel() // c, c, 1
    return None


def in_scope(x) -> bool:
    """Whether `BatchNorm` in training takes the kernels for x: a CUDA
    tensor (whose dtype the kernels check)."""
    return x.is_cuda


@functools.lru_cache(maxsize=None)
def splits(outer: int, c: int, inner: int) -> int:
    """Blocks along the reduced axis (the partials of each sum): about
    `_BLOCKS` blocks in all, with at least 128 rows or 2048 positions a
    block. A function of the shape alone, so a shape always sums in the same
    order."""
    if inner == 1:
        return max(1, min(_BLOCKS // -(-c // 256), -(-outer // 128)))
    return max(1, min(_BLOCKS // c, -(-(outer * inner) // 2048)))


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_cuda.library("batch_norm"), name)
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [cll, ci, cll, ci]
    fn.argtypes = {
        "avec_bn_stats": [vp, vp, vp, *shape, ctypes.c_float, ci, vp],
        "avec_bn_apply": [vp] * 6 + shape + [ci, ci, vp],
        "avec_bn_bwd_reduce": [vp] * 7 + shape + [ci, vp],
        "avec_bn_bwd_dx": [vp] * 7 + shape + [ci, vp],
    }[name]
    fn.restype = ci
    return fn


def _check(x, *like):
    """x's (outer, C, inner, splits, is_bf16) for a kernel call; every
    tensor of `like` (None skipped) must match x's shape, strides and dtype."""
    req = _cuda.require
    req(x.is_cuda, "x must be a CUDA tensor")
    req(x.dtype in _DTYPES, f"x must be fp32 or bf16, got {x.dtype}")
    lay = layout(x)
    req(lay is not None, "x must be contiguous or channels-last, with "
        "channels on axis 1")
    for t in like:
        req(t is None or (t.shape == x.shape and t.stride() == x.stride()
                          and t.dtype == x.dtype and t.device == x.device),
            "every activation must have x's shape, strides, dtype and device")
    return (*lay, splits(*lay), int(x.dtype == torch.bfloat16))


def _f32(v):
    return v.float().contiguous()


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _gate(g, y):
    """g where the ReLU's output y is above 0, else 0 (threshold_backward)."""
    return g if y is None else torch.where(y <= 0, torch.zeros_like(g), g)


def _width(x, c: int, inner: int) -> int:
    """Values a kernel thread loads at once (`width` in csrc/batch_norm.cu):
    16 bytes where the channel run (rows: C; planes: inner) holds a whole
    number of them and x is 16-byte aligned, else one."""
    v = 16 // x.element_size()
    run = c if inner == 1 else inner
    return v if run % v == 0 and x.data_ptr() % 16 == 0 else 1


def _serial(t):
    """t[0] + t[1] + ... along axis 0, one add after another."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def _halve(t, dim: int):
    """The sum over `dim` (a power of two long) as a tree of the kernels
    adds it: the first half plus the second, until one is left."""
    while t.shape[dim] > 1:
        h = t.shape[dim] // 2
        t = t.narrow(dim, 0, h) + t.narrow(dim, h, h)
    return t.squeeze(dim)


def _padded(t, dim: int, size: int):
    """t with zeros after its end along `dim` up to `size` (adding 0 leaves
    a sum as it is)."""
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def _kernel_order_sums(xf, lay, v: int):
    """(sum, sum of squares) per channel of the fp32 x, viewed by `lay`
    with the width v, in the order of the stats kernel."""
    outer, c, inner = lay
    n_split = splits(outer, c, inner)
    parts = []
    for t in (xf, xf * xf):
        if inner == 1:                   # rows: each thread walks rows
            tx = 1
            while tx < c // v and tx < 32:
                tx *= 2
            ty = _THREADS // tx
            step = n_split * ty
            k = -(-outer // step)
            rows = _padded(t.movedim(1, -1).reshape(outer, c), 0, k * step)
            parts.append(_halve(_serial(rows.view(k, n_split, ty, c)), 1))
        else:                            # planes: vectors of v along inner
            per = inner // v
            m = outer * per
            step = n_split * _THREADS
            k = -(-m // step)
            e = t.reshape(outer, c, per, v).transpose(0, 1).reshape(c, m, v)
            e = _padded(_serial(e.movedim(2, 0)), 1, k * step)
            e = _serial(e.view(c, k, n_split, _THREADS // 32, 32).movedim(1, 0))
            parts.append(_serial(_halve(e, 3).movedim(2, 0)).t())
    j = -(-n_split // _FINISH_ROWS)
    return tuple(
        _halve(_serial(_padded(p, 0, j * _FINISH_ROWS)
                       .view(j, _FINISH_ROWS, c)), 0)
        for p in parts)


class _Sums(torch.autograd.Function):
    """`_kernel_order_sums` with their derivative, g1 + 2 x g2 on every
    element, as the backward (not a graph through each add)."""

    @staticmethod
    def forward(ctx, xf, lay, v):
        ctx.save_for_backward(xf)
        return _kernel_order_sums(xf, lay, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g1, g2):
        xf, = ctx.saved_tensors
        return _chan(g1, xf) + 2.0 * xf * _chan(g2, xf), None, None


def sums_reference(x, xf=None):
    """Per channel (sum x, sum x^2) in fp32, differentiable in `xf` (x in
    fp32, by default x.float()), added in the order the stats kernel adds
    them: each thread's walk one add after another, the block's tree (rows)
    or its warps' shuffle tree and then its warps in turn (planes), then the
    finishing kernel's walk over the partials and its tree. Every term is x
    (or x x, rounded) in fp32, so the kernel and this give the same bits.
    An x that `layout` cannot view (empty) takes PyTorch's sums."""
    xf = x.float() if xf is None else xf
    lay = layout(x)
    if lay is None:
        return xf.sum(dim=_axes(x)), (xf * xf).sum(dim=_axes(x))
    return _Sums.apply(xf, lay, _width(x, lay[1], lay[2]))


def rstd(var, eps: float):
    """1 / sqrt(var + eps), each step rounded as IEEE fp32 rounds it, as the
    stats kernel computes it."""
    return torch.reciprocal(torch.sqrt(var + eps))


def moments(s1, s2, n: int):
    """(mean, E[x^2]) from the sums over n positions, each a division by n
    in fp32 (a tensor on the sums' device: PyTorch multiplies by the
    reciprocal of a scalar divisor on the card)."""
    nt = torch.full_like(s1, float(n))
    return s1 / nt, s2 / nt


def stats_reference(x, eps: float) -> torch.Tensor:
    mean, ex2 = moments(*sums_reference(x), x.numel() // x.shape[1])
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    return torch.stack([mean, var, rstd(var, eps)])


def stats(x, eps: float) -> torch.Tensor:
    """(3, C) fp32: mean, var, rstd of x's channels."""
    if x.device.type == "cpu":
        return stats_reference(x, eps)
    outer, c, inner, n_split, bf16 = _check(x)
    part = torch.empty(n_split * 2 * c, dtype=torch.float32, device=x.device)
    st = torch.empty((3, c), dtype=torch.float32, device=x.device)
    with _cuda.launch(KERNEL_STATS):
        rc = _fn("avec_bn_stats")(
            x.data_ptr(), part.data_ptr(), st.data_ptr(), outer, c, inner,
            n_split, eps, bf16, _cuda.stream_ptr(x))
        _cuda.check(rc, KERNEL_STATS)
    return st


def apply_reference(x, st, weight, bias, residual=None,
                    relu: bool = False) -> torch.Tensor:
    y = (x.float() - _chan(st[0], x)) * _chan(st[2], x)
    y = (y * _chan(weight, x) + _chan(bias, x)).to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def apply(x, st, weight, bias, residual=None, relu: bool = False):
    """relu?(round((x - mean) rstd w + b) + residual?) in x's dtype and
    layout; `residual` has x's shape, strides and dtype."""
    if x.device.type == "cpu":
        return apply_reference(x, st, weight, bias, residual, relu)
    outer, c, inner, n_split, bf16 = _check(x, residual)
    out = torch.empty_like(x)
    w, b = _f32(weight), _f32(bias)
    with _cuda.launch(KERNEL_APPLY):
        rc = _fn("avec_bn_apply")(
            x.data_ptr(), _ptr(residual), st.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), outer, c, inner, n_split,
            int(relu), bf16, _cuda.stream_ptr(x))
        _cuda.check(rc, KERNEL_APPLY)
    return out


def bwd_reduce_reference(g, x, y, st, weight) -> torch.Tensor:
    n = x.numel() // x.shape[1]
    gp = _gate(g, y).float()
    xhat = (x.float() - _chan(st[0], x)) * _chan(st[2], x)
    db = gp.sum(dim=_axes(x))
    dw = (gp * xhat).sum(dim=_axes(x))
    return torch.stack([db, dw, weight.float() * st[2], db / n, dw / n])


def bwd_reduce(g, x, y, st, weight) -> torch.Tensor:
    """(5, C) fp32: db, dw, w rstd, db / n, dw / n for the gradient g of the
    output; y, the output, gates g where the forward applied a ReLU (None:
    no ReLU)."""
    if x.device.type == "cpu":
        return bwd_reduce_reference(g, x, y, st, weight)
    outer, c, inner, n_split, bf16 = _check(x, g, y)
    part = torch.empty(n_split * 2 * c, dtype=torch.float32, device=x.device)
    red = torch.empty((5, c), dtype=torch.float32, device=x.device)
    w = _f32(weight)
    with _cuda.launch(KERNEL_BWD_REDUCE):
        rc = _fn("avec_bn_bwd_reduce")(
            g.data_ptr(), _ptr(y), x.data_ptr(), st.data_ptr(), w.data_ptr(),
            part.data_ptr(), red.data_ptr(), outer, c, inner, n_split, bf16,
            _cuda.stream_ptr(x))
        _cuda.check(rc, KERNEL_BWD_REDUCE)
    return red


def bwd_dx_reference(g, x, y, st, red, write_g: bool = False):
    gp = _gate(g, y)
    xhat = (x.float() - _chan(st[0], x)) * _chan(st[2], x)
    dx = (_chan(red[2], x) * (gp.float() - _chan(red[3], x)
                              - xhat * _chan(red[4], x))).to(x.dtype)
    return dx, (gp if write_g else None)


def bwd_dx(g, x, y, st, red, write_g: bool = False):
    """(dx, g' or None): x's gradient in its dtype and layout, and with
    `write_g` the gated gradient g' that the residual branch receives."""
    if x.device.type == "cpu":
        return bwd_dx_reference(g, x, y, st, red, write_g)
    outer, c, inner, n_split, bf16 = _check(x, g, y)
    dx = torch.empty_like(x)
    gres = torch.empty_like(x) if write_g else None
    with _cuda.launch(KERNEL_BWD_DX):
        rc = _fn("avec_bn_bwd_dx")(
            g.data_ptr(), _ptr(y), x.data_ptr(), st.data_ptr(),
            red.data_ptr(), dx.data_ptr(), _ptr(gres), outer, c, inner,
            n_split, bf16, _cuda.stream_ptr(x))
        _cuda.check(rc, KERNEL_BWD_DX)
    return dx, gres


def _like(t, x):
    """t laid out as x (same strides), copied where it is not."""
    return t if t.stride() == x.stride() else torch.empty_like(x).copy_(t)


class _BatchNormTrain(torch.autograd.Function):
    """stats + apply forward, bwd-reduce + bwd-dx backward; saves x, the
    output where a ReLU gates the gradient, the statistics and the weight."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, eps, relu):
        st = stats(x, eps)
        out = apply(x, st, weight, bias, residual, relu)
        ctx.save_for_backward(x, out if relu else None, st, weight)
        ctx.residual = residual is not None
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(st)
        return out, st

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _gst):
        x, y, st, weight = ctx.saved_tensors
        g = _like(g, x)
        red = bwd_reduce(g, x, y, st, weight)
        dx, gres = bwd_dx(g, x, y, st, red,
                          write_g=ctx.residual and y is not None)
        if ctx.residual and gres is None:
            gres = g
        return (dx, red[1].to(weight.dtype), red[0].to(ctx.bias_dtype), gres,
                None, None)


def batch_norm_train(x, weight, bias, eps: float, residual=None,
                     relu: bool = False):
    """relu?(BN(x) + residual?) with x's batch statistics, differentiable in
    x, weight, bias and residual. Returns (out, (3, C) fp32 mean, var,
    rstd); the caller moves the running statistics. `residual` has x's
    shape and dtype (copied into x's layout where its strides differ)."""
    if layout(x) is None:
        x = x.contiguous()
    if residual is not None:
        _cuda.require(residual.shape == x.shape and residual.dtype == x.dtype,
                      "residual must have x's shape and dtype")
        residual = _like(residual, x)
    return _BatchNormTrain.apply(x, weight, bias, residual, eps, relu)
