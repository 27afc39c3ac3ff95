"""Flash rel-pos attention (port of avec_tpu/ops/pallas_attention.py).

The factorized rel-pos decomposition turns the skewed relative attention into
plain scores q' k'^T over augmented features

    q' = [q, a1, a2, q.b_pos]   (T, d + D + 1)
    k' = [k, cos_t, sin_t, 1]   (T, d + D + 1)

so one online-softmax kernel computes the layer without a (T, T) tensor in
device memory. `flash_attention_fwd` launches the hand-written CUDA kernel
(`csrc/flash_attention.cu`) for CUDA tensors and computes the plain version
for CPU tensors; `flash_attention_reference` is that plain version.
"""

import ctypes
import math
from typing import Tuple

import torch

from avec_tpu_torch.ops import _cuda

NEG_INF = -1e30
KERNEL = "flash_attention_fwd"


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


def _lib():
    lib = _cuda.library("flash_attention")
    fn = lib.avec_flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


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
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=q_aug.device)
    req(lengths.shape == (b,) and lengths.dtype == torch.int32
        and lengths.device == q_aug.device and lengths.is_contiguous(),
        "lengths must be a contiguous (B,) int32 tensor on the same device")
    out = torch.empty((b, h, t, dv), dtype=v.dtype, device=v.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=v.device)
    rc = _lib()(q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
                b * h, h, t, da, dv, float(scale),
                int(q_aug.dtype == torch.bfloat16), _cuda.stream_ptr(q_aug))
    _cuda.check(rc, KERNEL)
    _cuda.launches[KERNEL] += 1
    return out, lse


def flash_attention(q_aug, k_aug, v, lengths=None, scale=1.0,
                    use_kernel: bool = True) -> torch.Tensor:
    """(B, H, T, dv) attention output (pallas_attention.py:163).
    use_kernel=False runs the plain version on any device."""
    fn = flash_attention_fwd if use_kernel else flash_attention_reference
    return fn(q_aug, k_aug, v, lengths, scale)[0]


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
    inv_freq = (1.0 / (10000.0 ** (2.0 * torch.arange(
        half, dtype=torch.float64) / dim_model))).to(torch.float32).to(q.device)
    ang = pos[:, None] * inv_freq[None, :]
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
    return flash_attention(q_aug, k_aug, v.contiguous(), lengths, scale,
                           use_kernel=use_kernel)
