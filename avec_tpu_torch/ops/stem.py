"""Video-stem BN-apply + ReLU + max pool (port of avec_tpu/ops/pallas_stem.py).

`bn_relu_pool` launches the hand-written CUDA kernel (`csrc/stem.cu`) for
CUDA tensors and computes the plain version for CPU tensors;
`bn_relu_pool_reference` is that plain version. The stem conv itself stays a
plain `F.conv3d`, as the JAX package leaves it to XLA.
"""

import ctypes

import torch
import torch.nn.functional as F

from avec_tpu_torch.ops import _cuda

KERNEL = "bn_relu_pool"


def bn_relu_pool_reference(y, a, b) -> torch.Tensor:
    """relu(a*y + b) in fp32, rounded to y's dtype, then 3x3/2 max pool with
    pad 1. y: (N, H, W, C) channels-last; a, b: (C,) fp32."""
    z = torch.relu(y.float() * a.float() + b.float()).to(y.dtype)
    out = F.max_pool2d(z.permute(0, 3, 1, 2), 3, 2, padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def _lib():
    fn = _cuda.library("stem").avec_bn_relu_pool
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def bn_relu_pool(y, a, b) -> torch.Tensor:
    """Fused BN-apply + ReLU + 3x3/2 max pool over (N, H, W, C) frames
    (pallas_stem.py:136). CPU tensors take the plain version."""
    if y.device.type == "cpu":
        return bn_relu_pool_reference(y, a, b)
    req = _cuda.require
    n, h, w, c = y.shape
    req(y.is_cuda and a.device == y.device and b.device == y.device,
        "y, a, b must share one CUDA device")
    req(y.dtype in (torch.float32, torch.bfloat16),
        f"y must be fp32 or bf16, got {y.dtype}")
    req(a.dtype == torch.float32 and b.dtype == torch.float32
        and a.shape == (c,) and b.shape == (c,), "a, b must be (C,) fp32")
    req(y.is_contiguous() and a.is_contiguous() and b.is_contiguous(),
        "y, a, b must be contiguous (channels-last frames)")
    out = torch.empty((n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                      dtype=y.dtype, device=y.device)
    rc = _lib()(y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                n, h, w, c, int(y.dtype == torch.bfloat16),
                _cuda.stream_ptr(y))
    _cuda.check(rc, KERNEL)
    _cuda.launches[KERNEL] += 1
    return out


def fused_stem_eval(x, conv_weight, conv_bias, scale, bn_bias, ra_mean,
                    ra_var, eps: float = 1e-5, use_kernel: bool = True):
    """Eval-mode stem (pallas_stem.py:267): Conv3d 1->64 k(5,7,7) s(1,2,2)
    'same', then BN with running stats + ReLU + pool in one kernel.

    x: (B, T, 88, 88, 1) channels-last. Returns (B*T, 22, 22, 64)."""
    y = stem_conv(x, conv_weight, conv_bias)
    a = scale.float() * torch.rsqrt(ra_var.float() + eps)
    bb = bn_bias.float() - ra_mean.float() * a
    fn = bn_relu_pool if use_kernel else bn_relu_pool_reference
    return fn(y, a.contiguous(), bb.contiguous())


def stem_conv(x, weight, bias):
    """(B, T, H, W, 1) -> conv frames (B*T, H/2, W/2, 64), channels-last."""
    bsz, t = x.shape[0], x.shape[1]
    # C_in = 1, so the channels-last-3d view costs no copy; cuDNN then
    # writes channels-last output and the permute below is free.
    x5 = x.permute(0, 4, 1, 2, 3).contiguous(
        memory_format=torch.channels_last_3d)
    y = F.conv3d(x5, weight.to(x.dtype), bias.to(x.dtype), stride=(1, 2, 2),
                 padding=(2, 3, 3))
    y = y.permute(0, 2, 3, 4, 1)
    return y.reshape((bsz * t,) + y.shape[2:]).contiguous()
