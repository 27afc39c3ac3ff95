"""Video-stem BN-apply + ReLU + max pool (port of avec_tpu/ops/pallas_stem.py).

`bn_relu_pool` launches the hand-written CUDA kernel (`csrc/stem.cu`) for
CUDA tensors and computes the plain version for CPU tensors;
`bn_relu_pool_reference` is that plain version. The stem conv itself stays a
plain `F.conv3d`, as the JAX package leaves it to XLA. `fused_stem_eval`
applies the kernel with the running statistics, `fused_stem_train` with the
batch's, computed by the BatchNorm kernels of `ops/batch_norm.py`, which
also run its BN backward (the JAX package's backward is plain XLA).
"""

import ctypes

import torch
import torch.nn.functional as F

from avec_tpu_torch.ops import _cuda, batch_norm

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
    (pallas_stem.py:136). CPU tensors take the plain version; on the card C
    must be a multiple of 8 in bf16 or 4 in fp32 (16-byte loads)."""
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
    vec = 8 if y.dtype == torch.bfloat16 else 4     # channels in 16 bytes
    req(c % vec == 0, f"C must be a multiple of {vec} for {y.dtype}, got {c}")
    req(y.data_ptr() % 16 == 0, "y must be 16-byte aligned")
    out = torch.empty((n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                      dtype=y.dtype, device=y.device)
    with _cuda.launch(KERNEL):
        rc = _lib()(y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    n, h, w, c, int(y.dtype == torch.bfloat16),
                    _cuda.stream_ptr(y))
        _cuda.check(rc, KERNEL)
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


class _FusedStemTrain(torch.autograd.Function):
    """Conv + single-pass batch statistics + the BN/ReLU/pool kernel; saves
    x and the conv output y and recomputes the pre-pool activation in the
    backward (pallas_stem.py:195-261)."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, bn_bias, eps, use_kernel):
        y = stem_conv(x, weight.detach(), bias.detach())
        stats = batch_norm.stats if use_kernel else batch_norm.stats_reference
        st = stats(y.view(-1, y.shape[-1]), eps)               # (rows, 64)
        mean, var = st[0], st[1]
        a = scale.detach().float() * st[2]
        b = bn_bias.detach().float() - mean * a
        fn = bn_relu_pool if use_kernel else bn_relu_pool_reference
        pooled = fn(y, a.contiguous(), b.contiguous())
        ctx.save_for_backward(x, weight, y, st, scale, a, b)
        ctx.use_kernel = use_kernel
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, gp, _gmean, _gvar):
        x, weight, y, st, scale, a, b = ctx.saved_tensors
        # the pre-pool activation with the forward's rounding; the pool's
        # backward runs in y's dtype and the ReLU gate follows it
        z = torch.relu(y.float() * a + b).to(y.dtype).permute(0, 3, 1, 2)
        with torch.enable_grad():
            zr = z.detach().requires_grad_(True)
            pooled = F.max_pool2d(zr, 3, 2, padding=1)
        ghat, = torch.autograd.grad(pooled, zr,
                                    gp.permute(0, 3, 1, 2).to(y.dtype))
        ghat = torch.where(z > 0, ghat, torch.zeros_like(ghat))
        c = y.shape[-1]
        g = ghat.permute(0, 2, 3, 1).reshape(-1, c)
        del z, zr, pooled, ghat
        # train-mode BN backward over the (rows, 64) view, reductions in fp32
        y2 = y.view(-1, c)
        if ctx.use_kernel:
            red = batch_norm.bwd_reduce(g, y2, None, st, scale)
            dy = batch_norm.bwd_dx(g, y2, None, st, red)[0]
        else:
            red = batch_norm.bwd_reduce_reference(g, y2, None, st, scale)
            dy = batch_norm.bwd_dx_reference(g, y2, None, st, red)[0]
        dy = dy.view(y.shape)
        dbn_bias, dscale = red[0], red[1]
        del g
        bsz, t = x.shape[0], x.shape[1]
        dy5 = dy.reshape((bsz, t) + dy.shape[1:]).permute(0, 4, 1, 2, 3)
        dweight = torch.nn.grad.conv3d_weight(
            _conv_input(x), weight.shape, dy5, stride=(1, 2, 2),
            padding=(2, 3, 3))
        # BN subtracts the batch mean of the conv output, so the conv bias
        # cannot reach the loss: its gradient is an exact zero
        return (None, dweight.to(weight.dtype), torch.zeros_like(scale),
                dscale.to(scale.dtype), dbn_bias.to(scale.dtype), None, None)


def fused_stem_train(x, conv_weight, conv_bias, scale, bn_bias,
                     eps: float = 1e-5, use_kernel: bool = True):
    """Training-mode stem (pallas_stem.py:174): the conv, batch statistics in
    one fp32 pass over all B*T*44*44 positions (var = max(E[y^2] - mean^2,
    0); the `ops/batch_norm.py` stats kernel), then BN with them + ReLU +
    pool in one kernel.

    x: (B, T, 88, 88, 1) channels-last. Returns (pooled (B*T, 22, 22, 64),
    batch mean, batch var); the caller updates the running statistics. The
    backward: max-pool backward in y's dtype on the recomputed activation
    and the ReLU gate in plain PyTorch, the train-mode BN backward in the
    `ops/batch_norm.py` kernels, the conv's weight gradient, a zero
    conv-bias gradient and no input gradient. use_kernel=False takes the
    plain versions of the BN + ReLU + pool kernel and of the BatchNorm
    kernels on any device."""
    return _FusedStemTrain.apply(x, conv_weight, conv_bias, scale, bn_bias,
                                 eps, use_kernel)


def _conv_input(x):
    """(B, T, H, W, 1) -> (B, 1, T, H, W). C_in = 1, so the channels-last-3d
    view costs no copy; cuDNN then writes channels-last output and the
    permute in `stem_conv` is free."""
    return x.permute(0, 4, 1, 2, 3).contiguous(
        memory_format=torch.channels_last_3d)


def stem_conv(x, weight, bias):
    """(B, T, H, W, 1) -> conv frames (B*T, H/2, W/2, 64), channels-last."""
    bsz, t = x.shape[0], x.shape[1]
    y = F.conv3d(_conv_input(x), weight.to(x.dtype), bias.to(x.dtype),
                 stride=(1, 2, 2), padding=(2, 3, 3))
    y = y.permute(0, 2, 3, 4, 1)
    return y.reshape((bsz * t,) + y.shape[2:]).contiguous()
