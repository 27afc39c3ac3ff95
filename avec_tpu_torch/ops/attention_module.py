"""Fused conformer attention module (port of
avec_tpu/ops/pallas_attention_module.py).

    h = LN(x)                                  fp32 statistics, eps 1e-6
    q, k, v = h Wq^T + bq, h Wk^T + bk, h Wv^T + bv
    per head:  s = q_h k_h^T + relpos_factorized(q_h) + q_h . b_pos_h
               s = s / sqrt(dh) + (-1e9 on key columns at or past the length)
               o_h = softmax_fp32(s) v_h
    y = dropout(concat(o_h) Wo^T + bo) [+ x]

`fused_attention_module_3d` launches the hand-written CUDA kernels
(`csrc/attention_module.cu`, one call per direction) for CUDA tensors and
computes the plain version for CPU tensors;
`fused_attention_module_reference` is that plain version, differentiated by
autograd. Weights keep the port's Linear layout (out, in), the positional
projection as `pos_layer.weight`, so the module hands its parameters over
without a transposed copy (the JAX function takes (in, out) kernels).

Rounding follows the TPU kernel. Forward (pallas_attention_module.py:83-146):
every projection is rounded to x's dtype before its bias is added there; the
score terms q k^T, the rel-pos term and q . b_pos are each rounded, summed in
x's dtype, scaled in fp32, rounded, and the mask is added in x's dtype; the
softmax is fp32 and is rounded for the product with v; dropout multiplies in
fp32 before the last cast; the residual is added after it. Backward
(:149-271): the softmax stays fp32 and every score-side product runs on fp32
operands; g * mask, dq, dk and dv are rounded to x's dtype where they meet a
weight (dWo, the cotangent of the merged heads, dWq/dWk/dWv, dh). The plain
version keeps fp32 tensors that hold rounded values, with straight-through
rounding, so autograd reproduces those casts.

Rows past a sequence's length are computed and differentiated like any other
and a sequence of length 0 softmaxes uniformly over all T keys: the mask is
an additive -1e9 on key columns only. The dropout mask is the counter hash of
`ops/ffn.py:dropout_mask` with one tile per sequence
(pallas_conv_module.py:72-87), the same in the forward, the backward, the
plain version and the JAX kernel in interpret mode. For bf16 inputs of up to
736 frames with heads of at most 128 (every training shape) the kernels run
their products on the tensor cores, the backward's fp32 operands (dO, the
softmax, ds and the rel-pos cotangent) at fp32 precision as three bf16
parts, and write every parameter gradient with one owner per element, so
the backward gives the same bits on every run. fp32 inputs, and other bf16
ones, take the first version's fp32 FMA stages, which add the parameter
gradients into zeroed fp32 buffers with atomicAdd, so their last bits vary
from run to run; the two bf16 routes agree to fp32 summation order.
"""

import ctypes
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.ffn import _M32, _threshold, dropout_mask, shard_seed

KERNEL_FWD = "fused_att_fwd"
KERNEL_BWD = "fused_att_bwd"
NEG_INF = -1e9

_tables = {}


def pos_tables(t: int, dim_model: int, dtype, device):
    """sin and cos angle tables (T, d/2): fp32 angles, rounded to `dtype`
    (pallas_attention_module.py:407-415)."""
    half = dim_model // 2
    pos = torch.arange(t, dtype=torch.float32, device=device)
    inv_freq = torch.from_numpy((1.0 / (10000.0 ** (
        2.0 * np.arange(half) / dim_model))).astype(np.float32)).to(device)
    ang = pos[:, None] * inv_freq[None, :]
    return torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)


def _interleaved_table(t: int, dim_model: int, dtype, device) -> torch.Tensor:
    """(T, d) table for the kernels: sin at even, cos at odd columns, built
    once per (T, d, dtype, device)."""
    key = (t, dim_model, dtype, str(device))
    if key not in _tables:
        sin_t, cos_t = pos_tables(t, dim_model, dtype, device)
        _tables[key] = torch.stack([sin_t, cos_t], dim=-1).reshape(
            t, dim_model).contiguous()
    return _tables[key]


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to `dtype` (kept in fp32)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float(), None


def _value_of(value, smooth):
    """`value` in the forward, the gradient of `smooth` in the backward."""
    return value.detach() + (smooth - smooth.detach())


def fused_attention_module_reference(
        x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight, pos_bias, wo, bo, *,
        num_heads: int, lengths=None, seed: int = 0, drop_rate: float = 0.0,
        train: bool = False, residual: bool = True, ln_eps: float = 1e-6
) -> torch.Tensor:
    """Plain PyTorch twin of the kernels on (B, T, d), with the casts listed
    in the module docstring. Every tensor below is fp32 and holds values of
    x's dtype where the TPU kernel holds that dtype."""
    cdt = x.dtype
    b, t, d = x.shape
    dh = d // num_heads
    exact = cdt == torch.float32

    def r(a):                      # straight-through rounding to x's dtype
        return a if exact else _value_of(a.to(cdt).float(), a)

    def rg(a):                     # the cotangent is rounded instead
        return a if exact else _RoundGrad.apply(a, cdt)

    def proj(inp, w, bias):        # `_proj`: round the product, then the bias
        return r(r(rg(inp @ r(w.float()).t())) + r(bias.float()))

    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + ln_eps)
    smooth = xhat * ln_w.float() + ln_b.float()
    h = smooth if exact else _value_of(
        r(r(r(xhat) * r(ln_w.float())) + r(ln_b.float())), smooth)

    def heads(a):
        return a.reshape(b, t, num_heads, dh).transpose(1, 2)

    q, k, v = (heads(proj(h, w, bias))
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    sin_t, cos_t = (a.float() for a in pos_tables(t, d, cdt, x.device))
    w_pos = r(pos_weight.float()).reshape(num_heads, dh, d)
    u = r(torch.einsum("bhtc,hcm->bhtm", q, w_pos))
    us, uc = u[..., 0::2], u[..., 1::2]
    a1 = r(r(us * sin_t) + r(uc * cos_t))
    a2 = r(r(uc * sin_t) - r(us * cos_t))
    s_e = r(a1 @ cos_t.t() + a2 @ sin_t.t())
    s_k = r(q @ k.transpose(-1, -2))
    qb = r(torch.einsum("bhtc,hc->bht", q,
                        r(pos_bias.float()).reshape(num_heads, dh)))[..., None]
    s = r(r(r(s_k + s_e) + qb) * (1.0 / math.sqrt(dh)))
    if lengths is not None:
        past = (torch.arange(t, device=x.device)[None, :]
                >= lengths.to(x.device)[:, None])[:, None, None, :]
        neg = torch.tensor(NEG_INF, device=x.device).to(cdt).float()
        s = r(s + past.float() * neg)
    att = torch.softmax(s, dim=-1)
    # att is rounded for the forward product only: dv takes the fp32 softmax
    o = att @ v if exact else _value_of(r(att) @ v, att @ v)
    merged = r(o).transpose(1, 2).reshape(b, t, d)
    y = proj(merged, wo, bo)
    if train and drop_rate > 0.0:
        mask = dropout_mask(seed, b * t, d, 1, 1.0 - drop_rate, x.device,
                            tile_rows=t)
        y = r(y * mask.reshape(b, t, d))
    if residual:
        y = r(y + xf)
    return y.to(cdt)


def _lib():
    lib = _cuda.library("attention_module")
    fwd, bwd = lib.avec_att_fwd, lib.avec_att_bwd
    size = lib.avec_att_scratch_floats
    if fwd.argtypes is None:
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        tail = [ci, ci, ci, ci, cf, cf, ci, ci, cu, cu, cf, ci, vp]
        fwd.argtypes = [vp] * 6 + tail
        bwd.argtypes = [vp] * 8 + tail
        fwd.restype = bwd.restype = ci
        size.argtypes = [ci] * 6
        size.restype = ctypes.c_longlong
    return fwd, bwd, size


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(a.data_ptr() for a in tensors))


def _check(x, params, lengths, num_heads):
    req = _cuda.require
    req(x.ndim == 3, f"x must be (B, T, d), got {tuple(x.shape)}")
    b, t, d = x.shape
    req(x.is_cuda and lengths.device == x.device
        and all(p.device == x.device for p in params),
        "x, lengths and the parameters must share one CUDA device")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"x must be fp32 or bf16, got {x.dtype}")
    req(all(p.dtype == torch.float32 and p.is_contiguous() for p in params),
        "parameters must be contiguous fp32 tensors")
    req(x.is_contiguous(), "x must be contiguous")
    req(lengths.dtype == torch.int32 and lengths.shape == (b,)
        and lengths.is_contiguous(), "lengths must be (B,) int32")
    req(num_heads > 0 and d % num_heads == 0 and d % 2 == 0,
        f"d={d} must be even and a multiple of num_heads={num_heads}")
    shapes = [(d,), (d,)] + [(d, d), (d,)] * 5
    req([tuple(p.shape) for p in params] == shapes,
        f"parameter shapes do not fit x {tuple(x.shape)}: weights must be "
        "(d, d) in the Linear (out, in) layout, biases (d,)")
    return b, t, d


class _FusedAttentionModule(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; only x, the parameters,
    the lengths and the seed are kept for the backward, which recomputes the
    rest."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight,
                pos_bias, wo, bo, lengths, seed, num_heads, drop_rate, train,
                residual, ln_eps):
        params = tuple(p.detach() for p in (ln_w, ln_b, wq, bq, wk, bk, wv,
                                            bv, pos_weight, pos_bias, wo, bo))
        x = x.detach()
        b, t, d = _check(x, params, lengths, num_heads)
        fwd, _, size = _lib()
        is_bf16 = int(x.dtype == torch.bfloat16)
        count = size(b, t, d, num_heads, 0, is_bf16)
        _cuda.require(count > 0, f"shape {tuple(x.shape)} with {num_heads} "
                      "heads is outside the kernels' range")
        drop = bool(train and drop_rate > 0.0)
        thr, inv_keep = _threshold(1.0 - drop_rate) if drop else (0, 1.0)
        tail = (b, t, d, num_heads, float(ln_eps),
                1.0 / math.sqrt(d // num_heads), int(bool(residual)),
                int(drop), int(seed) & _M32, thr, inv_keep, is_bf16)
        tab = _interleaved_table(t, d, x.dtype, x.device)
        scratch = torch.empty(count, dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        with _cuda.launch(KERNEL_FWD):
            rc = fwd(x.data_ptr(), tab.data_ptr(), lengths.data_ptr(),
                     _pointers(params), y.data_ptr(), scratch.data_ptr(),
                     *tail, _cuda.stream_ptr(x))
            _cuda.check(rc, KERNEL_FWD)
        ctx.save_for_backward(x, lengths, *params)
        ctx.tail = tail
        return y

    @staticmethod
    def backward(ctx, g):
        x, lengths, *params = ctx.saved_tensors
        b, t, d, num_heads = ctx.tail[:4]
        _, bwd, size = _lib()
        g = g.to(x.dtype).contiguous()
        tab = _interleaved_table(t, d, x.dtype, x.device)
        scratch = torch.empty(size(b, t, d, num_heads, 1, ctx.tail[-1]),
                              dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        grads = [torch.empty_like(p) for p in params]  # the call writes them
        with _cuda.launch(KERNEL_BWD):
            rc = bwd(x.data_ptr(), g.data_ptr(), tab.data_ptr(),
                     lengths.data_ptr(), _pointers(params), dx.data_ptr(),
                     _pointers(grads), scratch.data_ptr(), *ctx.tail,
                     _cuda.stream_ptr(x))
            _cuda.check(rc, KERNEL_BWD)
        return (dx, *grads, None, None, None, None, None, None, None)


def fused_attention_module_3d(
        x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight, pos_bias, wo, bo, *,
        num_heads: int, lengths=None, seed: Optional[int] = None,
        drop_rate: float = 0.0, deterministic: bool = True,
        residual: bool = True, ln_eps: float = 1e-6, use_kernel: bool = True
) -> torch.Tensor:
    """Fused pre-norm rel-pos self-attention module on (B, T, d)
    (pallas_attention_module.py:418): dropout(attention(LN(x))) [+ x].

    `lengths` (B,) gives each sequence's valid key count (None: unmasked);
    `seed` is a 31-bit integer, read only when training with dropout. CPU
    tensors take the plain version; CUDA tensors launch the kernels, in the
    backward too, and raise on what the kernels do not take.
    use_kernel=False runs the plain version on any device."""
    seed = 0 if seed is None else int(seed)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device).to(torch.int32)
    if x.device.type == "cpu" or not use_kernel:
        return fused_attention_module_reference(
            x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight, pos_bias, wo,
            bo, num_heads=num_heads, lengths=lengths, seed=seed,
            drop_rate=drop_rate, train=not deterministic, residual=residual,
            ln_eps=ln_eps)
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    return _FusedAttentionModule.apply(
        x.contiguous(), ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight,
        pos_bias, wo, bo, lengths.contiguous(), seed, num_heads, drop_rate,
        not deterministic, residual, ln_eps)


def fused_attention_module_3d_dp(
        x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight, pos_bias, wo, bo, *,
        num_heads: int, group=None, lengths=None, seed: Optional[int] = None,
        drop_rate: float = 0.0, deterministic: bool = True,
        residual: bool = True, ln_eps: float = 1e-6, use_kernel: bool = True
) -> torch.Tensor:
    """`fused_attention_module_3d` on this rank's shard of a batch (and of
    its lengths) split over the ranks of `group` (None: the default group),
    with the rank's dropout seed (pallas_attention_module.py:469-496).
    Attention has no cross-rank statistics; the parameter gradients are this
    rank's partial sums."""
    group = group if group is not None else dist.group.WORLD
    return fused_attention_module_3d(
        x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, pos_weight, pos_bias, wo, bo,
        num_heads=num_heads, lengths=lengths,
        seed=shard_seed(seed, dist.get_rank(group)), drop_rate=drop_rate,
        deterministic=deterministic, residual=residual, ln_eps=ln_eps,
        use_kernel=use_kernel)
