"""Fused conformer feed-forward module (port of avec_tpu/ops/pallas_ffn.py).

    h = cast(LN(x)) * cast(w) + cast(b)     LN statistics in fp32, eps 1e-6
    u = h W1^T + b1                          operands in x's dtype, fp32 sums
    s = swish(u) * m_inner
    y = (cast(s) W2^T + b2) * m_outer

`fused_ffn_3d` launches the hand-written CUDA kernels (`csrc/ffn.cu`, forward
and backward) for CUDA tensors and computes the plain version for CPU tensors;
`fused_ffn_reference` is that plain version, differentiated by autograd. The
weights keep the port's Linear layout, W1 (F, d) and W2 (d, F), so the module
hands its parameters over without a transposed copy (the JAX function takes
(d, F) and (F, d)).

The dropout masks are a pure function of (seed, row, column, draw): the
counter hash of pallas_ffn.py:76-108 (murmur3 finaliser), written per global
row. The kernels and the plain version regenerate the same masks, which are
also those of the JAX kernel in interpret mode. The bf16 forward and
backward write every output with one owner per element and sum in a fixed
order, so they give the same bits on every run; each needs a scratch buffer
(`fwd_scratch`, `bwd_scratch`).
The fp32 backward adds its weight and bias gradients into zeroed fp32
buffers with atomicAdd, so their last bits vary from run to run there.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avec_tpu_torch.ops import _cuda

KERNEL_FWD = "fused_ffn_fwd"
KERNEL_BWD = "fused_ffn_bwd"
MAX_DIM = 384                      # widest d the kernels are instantiated for

_TILE_N = 256                      # rows per hash tile (pallas_ffn.py:52)
_SEED_STRIDE = 1103515245
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finaliser on uint32 values held in int64 tensors."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _threshold(keep: float) -> Tuple[int, float]:
    """(uint32 keep threshold, fp32 multiplier 1/keep)."""
    return (min(int(keep * float(2 ** 32)), 2 ** 32 - 1),
            float(np.float32(1.0 / keep)))


def dropout_mask(seed: int, n: int, ncols: int, draw: int, keep: float,
                 device="cpu", tile_rows: int = _TILE_N) -> torch.Tensor:
    """(n, ncols) fp32 multipliers, 0 or 1/keep, of draw 1 (inner, ncols=F)
    or 2 (outer, ncols=d) for rows 0..n-1. The hash restarts every
    `tile_rows` rows with the next tile's key: 256 for the feed-forward
    module, T for the attention module (one tile per sequence)."""
    thr, inv_keep = _threshold(keep)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    cols = torch.arange(ncols, dtype=torch.int64, device=device)
    base = (int(seed) + (rows // tile_rows) * _SEED_STRIDE) & _M32
    key = _mix32((base + (draw * _GOLDEN) % (2 ** 32)) & _M32)
    flat = (((rows % tile_rows) * ncols)[:, None] + cols[None, :]) & _M32
    bits = _mix32(flat ^ key[:, None])
    return (bits < thr).to(torch.float32) * inv_keep


def fused_ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2, seed: int = 0,
                        epsilon: float = 1e-6, drop_rate: float = 0.0,
                        train: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernels on (N, d) tokens, with the casts of
    pallas_ffn.py:62-73 and :130-139 and the same hash masks."""
    cdt = x.dtype
    n, d = x.shape
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + epsilon)
    h = xhat.to(cdt) * ln_w.to(cdt) + ln_b.to(cdt)
    u = h.float() @ w1.to(cdt).float().t() + b1.float()
    s = u * torch.sigmoid(u)
    drop = train and drop_rate > 0.0
    if drop:
        s = s * dropout_mask(seed, n, w1.shape[0], 1, 1.0 - drop_rate, x.device)
    y = s.to(cdt).float() @ w2.to(cdt).float().t() + b2.float()
    if drop:
        y = y * dropout_mask(seed, n, d, 2, 1.0 - drop_rate, x.device)
    return y.to(cdt)


def _lib():
    lib = _cuda.library("ffn")
    fwd, bwd = lib.avec_ffn_fwd, lib.avec_ffn_bwd
    sizes = lib.avec_ffn_fwd_scratch_bytes, lib.avec_ffn_bwd_scratch_bytes
    if fwd.argtypes is None:
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        tail = [ci, ci, ci, cf, ci, cu, cu, cf, ci, vp]
        fwd.argtypes = [vp] * 9 + tail
        bwd.argtypes = [vp] * 15 + tail
        fwd.restype = bwd.restype = ci
        for size in sizes:
            size.argtypes = [ci] * 4
            size.restype = ctypes.c_longlong
    return fwd, bwd, sizes


def _scratch(x: torch.Tensor, f: int, backward: bool) -> torch.Tensor:
    n, d = x.shape
    size = _lib()[2][int(backward)](n, d, f, int(x.dtype == torch.bfloat16))
    return torch.empty(size, dtype=torch.uint8, device=x.device)


def fwd_scratch(x: torch.Tensor, f: int) -> torch.Tensor:
    """The forward kernel's scratch for (N, d) tokens `x` and hidden width
    `f`: a byte buffer on x's device (empty for fp32, whose kernel needs
    none)."""
    return _scratch(x, f, False)


def bwd_scratch(x: torch.Tensor, f: int) -> torch.Tensor:
    """The backward kernel's scratch, as `fwd_scratch`."""
    return _scratch(x, f, True)


def _check(x, params):
    req = _cuda.require
    n, d = x.shape
    ln_w, ln_b, w1, b1, w2, b2 = params
    f = w1.shape[0]
    req(x.is_cuda and all(p.device == x.device for p in params),
        "x and the parameters must share one CUDA device")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"x must be fp32 or bf16, got {x.dtype}")
    req(all(p.dtype == torch.float32 and p.is_contiguous() for p in params),
        "parameters must be contiguous fp32 tensors")
    req(x.is_contiguous(), "x must be contiguous")
    req(ln_w.shape == (d,) and ln_b.shape == (d,) and w1.shape == (f, d)
        and b1.shape == (f,) and w2.shape == (d, f) and b2.shape == (d,),
        f"parameter shapes do not fit x {tuple(x.shape)}: W1 must be (F, d), "
        "W2 (d, F)")
    req(0 < d <= MAX_DIM and n > 0, f"d={d} above the kernels' {MAX_DIM}")
    return n, d, f


class _FusedFFN(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; only x, the parameters
    and the seed are kept for the backward, which recomputes the rest."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, seed, epsilon, drop_rate,
                train):
        params = tuple(p.detach() for p in (ln_w, ln_b, w1, b1, w2, b2))
        x = x.detach()
        n, d, f = _check(x, params)
        drop = bool(train and drop_rate > 0.0)
        thr, inv_keep = _threshold(1.0 - drop_rate) if drop else (0, 1.0)
        tail = (n, d, f, float(epsilon), int(drop), int(seed) & _M32, thr,
                inv_keep, int(x.dtype == torch.bfloat16))
        y = torch.empty_like(x)
        scratch = fwd_scratch(x, f)
        with _cuda.launch(KERNEL_FWD):
            rc = _lib()[0](x.data_ptr(), *(p.data_ptr() for p in params),
                           y.data_ptr(), scratch.data_ptr(), *tail,
                           _cuda.stream_ptr(x))
            _cuda.check(rc, KERNEL_FWD)
        ctx.save_for_backward(x, *params)
        ctx.tail = tail
        return y

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2 = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = torch.empty_like(x)
        grads = [torch.empty_like(p)  # the call writes them
                 for p in (ln_w, ln_b, w1, b1, w2, b2)]
        scratch = bwd_scratch(x, w1.shape[0])
        with _cuda.launch(KERNEL_BWD):
            rc = _lib()[1](x.data_ptr(), g.data_ptr(), ln_w.data_ptr(),
                           ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           w2.data_ptr(), dx.data_ptr(),
                           *(t.data_ptr() for t in grads), scratch.data_ptr(),
                           *ctx.tail, _cuda.stream_ptr(x))
            _cuda.check(rc, KERNEL_BWD)
        return (dx, *grads, None, None, None, None)


def fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2, seed: int = 0,
              epsilon: float = 1e-6, drop_rate: float = 0.0,
              train: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """Fused FFN on (N, d) tokens (pallas_ffn.py:215). CPU tensors take the
    plain version; CUDA tensors launch the kernels, in the backward too.
    use_kernel=False runs the plain version on any device."""
    if x.device.type == "cpu" or not use_kernel:
        return fused_ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2, seed,
                                   epsilon, drop_rate, train)
    return _FusedFFN.apply(x, ln_w, ln_b, w1, b1, w2, b2, seed, epsilon,
                           drop_rate, train)


def fused_ffn_3d(x, ln_w, ln_b, w1, b1, w2, b2, *, seed: Optional[int] = None,
                 epsilon: float = 1e-6, drop_rate: float = 0.0,
                 deterministic: bool = True, use_kernel: bool = True
                 ) -> torch.Tensor:
    """(B, T, d) wrapper (pallas_ffn.py:351): flattens the tokens and
    restores the shape. `seed` is a 31-bit integer, read only when training
    with dropout."""
    b, t, d = x.shape
    y = fused_ffn(x.reshape(b * t, d).contiguous(), ln_w, ln_b, w1, b1, w2,
                  b2, 0 if seed is None else int(seed), epsilon, drop_rate,
                  not deterministic, use_kernel)
    return y.reshape(b, t, d)


_SHARD_SEED_STRIDE = 0x68E31DA5


def shard_seed(seed: Optional[int], rank: int) -> int:
    """The dropout seed of data-parallel rank `rank`: seed + (rank + 1) *
    0x68E31DA5 with int32 wraparound, as the JAX DP wrappers offset it
    (pallas_ffn.py:335-337), held as its uint32 bits; None counts as 0. The
    offset applies at world size 1 too."""
    return (int(seed or 0) + (rank + 1) * _SHARD_SEED_STRIDE) & _M32


def fused_ffn_3d_dp(x, ln_w, ln_b, w1, b1, w2, b2, *, group=None,
                    seed: Optional[int] = None, epsilon: float = 1e-6,
                    drop_rate: float = 0.0, deterministic: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
    """`fused_ffn_3d` on this rank's shard of a batch split over the ranks
    of `group` (None: the default group), with the rank's dropout seed
    (pallas_ffn.py:318). The module has no cross-rank statistics; its
    parameter gradients are this rank's partial sums."""
    group = group if group is not None else dist.group.WORLD
    return fused_ffn_3d(x, ln_w, ln_b, w1, b1, w2, b2,
                        seed=shard_seed(seed, dist.get_rank(group)),
                        epsilon=epsilon, drop_rate=drop_rate,
                        deterministic=deterministic, use_kernel=use_kernel)
