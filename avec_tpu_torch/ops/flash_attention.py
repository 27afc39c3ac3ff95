"""Flash rel-pos attention (port of avec_tpu/ops/pallas_attention.py).

The factorized rel-pos decomposition turns the skewed relative attention into
plain scores q' k'^T over augmented features

    q' = [q, a1, a2, q.b_pos]   (T, d + D + 1)
    k' = [k, cos_t, sin_t, 1]   (T, d + D + 1)

so one online-softmax kernel computes the layer without a (T, T) tensor in
device memory. `flash_attention_fwd` launches the hand-written CUDA kernels
(`csrc/flash_attention.cu`: for bf16 a prep stage writing aligned copies
into a scratch buffer, then the online softmax on the tensor cores) for CUDA
tensors and computes the plain version for CPU tensors;
`flash_attention_reference` is that plain version.

`flash_attention` is differentiable: its backward launches the kernels of
`csrc/flash_attention_bwd.cu` (`flash_attention_bwd`: for bf16 a prep stage
writing aligned copies into a scratch buffer, then dq and dk'/dV on the
tensor cores), or computes their plain version
`flash_attention_bwd_reference`. Both follow the rule of the JAX
custom VJP (pallas_attention.py:220, :260): p = exp(s - lse) is zero where the
key OR the query lies at or past the true length, so padded queries get a zero
gradient and a sequence of length 0 gets all-zero gradients.
`rel_pos_augment` stays plain PyTorch and is differentiated by autograd.
"""

import ctypes
import math
from typing import Tuple

import torch

from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.pos_embeddings import device_constant

NEG_INF = -1e30
KERNEL = "flash_attention_fwd"
KERNEL_DQ = "flash_attention_bwd_dq"
KERNEL_DKV = "flash_attention_bwd_dkv"
# `avec_flash_attention_bwd`'s `which`: bit 0 dq, bit 1 dk/dV (bf16 writes
# its aligned copies first in every call)
BWD_DQ, BWD_DKV = 1, 2
BWD_ALL = BWD_DQ | BWD_DKV
# the defines of the control builds whose bf16 kernels round p (the forward)
# and p and dS (the backward) to bf16 (`_cuda.control_library`), to measure
# what their three bf16 parts buy
ROUNDED_P = "AVEC_FLASH_FWD_PARTS=1"
ROUNDED_OPERANDS = "AVEC_FLASH_BWD_PARTS=1"


def flash_attention_reference(q_aug, k_aug, v, lengths=None, scale=1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel (pallas_attention.py:180-190).

    q_aug, k_aug: (B, H, T, da); v: (B, H, T, dv); lengths: (B,) or None.
    Returns (out (B, H, T, dv) in v's dtype, lse (B*H, T) fp32)."""
    b, h, t, _ = q_aug.shape
    scores = torch.einsum("bhqd,bhkd->bhqk", q_aug.float(), k_aug.float()) * scale
    if lengths is not None:
        col = torch.arange(t, device=q_aug.device)
        valid = col[None, :] < lengths.to(q_aug.device)[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    lse = torch.logsumexp(scores, dim=-1).reshape(b * h, t)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(v.dtype)
    return out, lse


def _lib(lib=None):
    """The forward's C entry and its scratch size of `lib` (the kernel
    library by default; a control build for measurements)."""
    lib = lib or _cuda.library("flash_attention")
    fn = lib.avec_flash_attention_fwd
    size = lib.avec_flash_attention_fwd_scratch_bytes
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 5 + [ctypes.c_float, ci, vp]
        fn.restype = ci
        size.argtypes = [ci] * 5
        size.restype = ctypes.c_longlong
    return fn, size


def fwd_scratch(q_aug: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward kernels' scratch for (B, H, T, d_a) `q_aug` and
    (B, H, T, d_v) `v`: a byte buffer on their device (empty for fp32, whose
    kernel needs none)."""
    b, h, t, da = q_aug.shape
    size = _lib()[1](b * h, t, da, v.shape[-1],
                     int(q_aug.dtype == torch.bfloat16))
    return torch.empty(size, dtype=torch.uint8, device=q_aug.device)


def flash_attention_fwd(q_aug, k_aug, v, lengths=None, scale=1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (out (B, H, T, dv), lse (B*H, T) fp32).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q_aug.device.type == "cpu":
        return flash_attention_reference(q_aug, k_aug, v, lengths, scale)
    b, h, t, da = q_aug.shape
    dv = v.shape[-1]
    req = _cuda.require
    req(q_aug.is_cuda and k_aug.device == q_aug.device
        and v.device == q_aug.device, "q', k', v must share one CUDA device")
    req(q_aug.dtype in (torch.float32, torch.bfloat16)
        and k_aug.dtype == q_aug.dtype and v.dtype == q_aug.dtype,
        f"dtypes must be one of fp32/bf16, got {q_aug.dtype}, {k_aug.dtype}, "
        f"{v.dtype}")
    req(k_aug.shape == q_aug.shape and v.shape == (b, h, t, dv),
        f"shapes {tuple(q_aug.shape)}, {tuple(k_aug.shape)}, {tuple(v.shape)}")
    req(q_aug.is_contiguous() and k_aug.is_contiguous() and v.is_contiguous(),
        "q', k', v must be contiguous")
    req(0 < dv <= 96, f"d_v={dv} above the kernel's 96")
    bf16 = q_aug.dtype == torch.bfloat16
    req(da <= 512 or not bf16, f"d_a={da} above the bf16 kernel's 512")
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=q_aug.device)
    req(lengths.shape == (b,) and lengths.dtype == torch.int32
        and lengths.device == q_aug.device and lengths.is_contiguous(),
        "lengths must be a contiguous (B,) int32 tensor on the same device")
    out = torch.empty((b, h, t, dv), dtype=v.dtype, device=v.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=v.device)
    scratch = fwd_scratch(q_aug, v)
    with _cuda.launch(KERNEL):
        rc = _lib()[0](q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
                       scratch.data_ptr(), b * h, h, t, da, dv, float(scale),
                       int(bf16), _cuda.stream_ptr(q_aug))
        _cuda.check(rc, KERNEL)
    return out, lse


def flash_attention_bwd_reference(q_aug, k_aug, v, dout, lse, delta,
                                  lengths=None, scale=1.0):
    """Plain PyTorch twin of the backward kernels
    (pallas_attention.py:193-277). dout: (B, H, T, dv); lse, delta: (B*H, T)
    fp32, delta = rowsum(dout * out). Returns (dq', dk', dv) in the input
    dtype."""
    b, h, t, _ = q_aug.shape
    qf, kf, vf, dof = (a.float() for a in (q_aug, k_aug, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if lengths is None:
        ok = torch.ones((b, 1, t, t), dtype=torch.bool, device=q_aug.device)
    else:
        valid = (torch.arange(t, device=q_aug.device)[None, :]
                 < lengths.to(q_aug.device)[:, None])
        ok = (valid[:, :, None] & valid[:, None, :])[:, None]
    # Masked entries never reach exp: a row without valid keys has a
    # degenerate lse.
    arg = (s - lse.reshape(b, h, t, 1)).masked_fill(~ok, NEG_INF)
    p = torch.exp(arg).masked_fill(~ok, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q_aug.dtype), dk.to(k_aug.dtype), dv.to(v.dtype)


def _lib_bwd(lib=None):
    """The backward's C entry and its scratch size of `lib` (the kernel
    library by default; a control build for measurements)."""
    lib = lib or _cuda.library("flash_attention_bwd")
    fn = lib.avec_flash_attention_bwd
    size = lib.avec_flash_attention_bwd_scratch_bytes
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [ci] * 5 + [ctypes.c_float] + [ci] * 2 + [vp]
        fn.restype = ci
        size.argtypes = [ci] * 5
        size.restype = ctypes.c_longlong
    return fn, size


def bwd_scratch(q_aug: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The backward kernels' scratch for (B, H, T, d_a) `q_aug` and
    (B, H, T, d_v) `v`: a byte buffer on their device (empty for fp32, whose
    kernels need none)."""
    b, h, t, da = q_aug.shape
    size = _lib_bwd()[1](b * h, t, da, v.shape[-1],
                         int(q_aug.dtype == torch.bfloat16))
    return torch.empty(size, dtype=torch.uint8, device=q_aug.device)


def flash_attention_bwd(q_aug, k_aug, v, dout, lse, delta, lengths=None,
                        scale=1.0):
    """(dq', dk', dv) of the flash attention. CPU tensors take the plain
    version; CUDA tensors launch the dq and the dk'/dV kernel (bf16: after
    the prep stage that writes their aligned copies into the scratch)."""
    if q_aug.device.type == "cpu":
        return flash_attention_bwd_reference(q_aug, k_aug, v, dout, lse,
                                             delta, lengths, scale)
    b, h, t, da = q_aug.shape
    dv = v.shape[-1]
    req = _cuda.require
    tensors = (q_aug, k_aug, v, dout)
    req(all(a.is_cuda and a.device == q_aug.device for a in tensors),
        "q', k', v, dout must share one CUDA device")
    req(q_aug.dtype in (torch.float32, torch.bfloat16)
        and all(a.dtype == q_aug.dtype for a in tensors),
        "q', k', v, dout must share one dtype, fp32 or bf16")
    req(k_aug.shape == q_aug.shape and v.shape == (b, h, t, dv)
        and dout.shape == v.shape,
        f"shapes {[tuple(a.shape) for a in tensors]}")
    req(all(a.is_contiguous() for a in tensors),
        "q', k', v, dout must be contiguous")
    req(0 < dv <= 128 and da <= 512,
        f"d_a={da}, d_v={dv} above the kernels' 512 and 128")
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=q_aug.device)
    req(lengths.shape == (b,) and lengths.dtype == torch.int32
        and lengths.device == q_aug.device and lengths.is_contiguous(),
        "lengths must be a contiguous (B,) int32 tensor on the same device")
    for name, a in (("lse", lse), ("delta", delta)):
        req(a.shape == (b * h, t) and a.dtype == torch.float32
            and a.device == q_aug.device and a.is_contiguous(),
            f"{name} must be a contiguous (B*H, T) fp32 tensor")
    dq = torch.empty_like(q_aug)
    dk = torch.empty_like(k_aug)
    dvv = torch.empty_like(v)
    scratch = bwd_scratch(q_aug, v)
    with _cuda.launch(KERNEL_DQ, KERNEL_DKV):
        rc = _lib_bwd()[0](
            q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            lengths.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            scratch.data_ptr(), b * h, h, t, da, dv, float(scale),
            int(q_aug.dtype == torch.bfloat16), BWD_ALL,
            _cuda.stream_ptr(q_aug))
        _cuda.check(rc, KERNEL_DQ)
    return dq, dk, dvv


class _FlashAttention(torch.autograd.Function):
    """Forward through `flash_attention_fwd`, backward through
    `flash_attention_bwd` (or both plain versions when use_kernel is False).
    delta = rowsum(dO * O) is plain PyTorch, as it is plain XLA in the JAX
    package (pallas_attention.py:307-310)."""

    @staticmethod
    def forward(ctx, q_aug, k_aug, v, lengths, scale, use_kernel):
        fwd = flash_attention_fwd if use_kernel else flash_attention_reference
        out, lse = fwd(q_aug, k_aug, v, lengths, scale)
        ctx.save_for_backward(q_aug, k_aug, v, out, lse)
        ctx.lengths, ctx.scale, ctx.use_kernel = lengths, scale, use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q_aug, k_aug, v, out, lse = ctx.saved_tensors
        g = g.to(v.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1).reshape(lse.shape)
        bwd = (flash_attention_bwd if ctx.use_kernel
               else flash_attention_bwd_reference)
        dq, dk, dv = bwd(q_aug, k_aug, v, g, lse, delta, ctx.lengths,
                         ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q_aug, k_aug, v, lengths=None, scale=1.0,
                    use_kernel: bool = True) -> torch.Tensor:
    """Differentiable (B, H, T, dv) attention output
    (pallas_attention.py:163, :281). use_kernel=False runs the plain
    versions, forward and backward, on any device."""
    return _FlashAttention.apply(q_aug, k_aug, v, lengths, scale, use_kernel)


def _inv_freq(dim_model: int, device) -> torch.Tensor:
    """(dim_model // 2,) 1 / 10000^(2i / dim_model), computed in fp64 on the
    host and rounded to fp32."""
    return device_constant(
        ("flash_inv_freq", dim_model), device,
        lambda: (1.0 / (10000.0 ** (2.0 * torch.arange(
            dim_model // 2, dtype=torch.float64) / dim_model))).to(
                torch.float32))


def rel_pos_augment(q, k, pos_kernel, pos_bias, dim_model, num_heads):
    """Augmented q', k' of pallas_attention.py:390-415.

    q, k: (B, H, T, d); pos_kernel (D, D) in (in, out) layout, pos_bias (D,).
    sin/cos are built in fp32 and cast to the activation dtype."""
    b, h, t, d = q.shape
    half = dim_model // 2
    dtype = q.dtype
    w = pos_kernel.reshape(dim_model, num_heads, d).to(dtype)
    ws, wc = w[0::2], w[1::2]
    bh_bias = pos_bias.reshape(num_heads, d).to(dtype)
    us = torch.einsum("bhid,mhd->bhim", q, ws)
    uc = torch.einsum("bhid,mhd->bhim", q, wc)
    pos = torch.arange(t, dtype=torch.float32, device=q.device)
    ang = pos[:, None] * _inv_freq(dim_model, q.device)[None, :]
    sin_t = torch.sin(ang).to(dtype)
    cos_t = torch.cos(ang).to(dtype)
    a1 = us * sin_t + uc * cos_t
    a2 = uc * sin_t - us * cos_t
    qb = torch.einsum("bhid,hd->bhi", q, bh_bias)[..., None]
    q_aug = torch.cat([q, a1, a2, qb], dim=-1)
    ones = torch.ones((b, h, t, 1), dtype=dtype, device=q.device)
    k_aug = torch.cat([k, cos_t.expand(b, h, t, half),
                       sin_t.expand(b, h, t, half), ones], dim=-1)
    return q_aug, k_aug


def rel_pos_flash_attention(q, k, v, pos_kernel, pos_bias, dim_model,
                            num_heads, lengths=None, use_kernel: bool = True):
    """Rel-pos self-attention through the flash kernel
    (pallas_attention.py:381). q, k, v: (B, H, T, d) projected heads."""
    q_aug, k_aug = rel_pos_augment(q, k, pos_kernel, pos_bias, dim_model,
                                   num_heads)
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    scale = 1.0 / math.sqrt(q.shape[-1])
    return flash_attention(q_aug.contiguous(), k_aug.contiguous(),
                           v.contiguous(), lengths, scale,
                           use_kernel=use_kernel)
