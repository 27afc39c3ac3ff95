"""Fused conformer convolution module (port of
avec_tpu/ops/pallas_conv_module.py), training mode.

    h  = LN(x)                          fp32 statistics, eps 1e-6
    a  = h W1a^T + b1a,  bg = h W1b^T + b1b   (the two halves of pw1)
    z  = a * sigmoid(bg)                GLU
    c  = depthwise_k(z) + b_dw          zero outside [0, T) of each sequence
    cn = BN(c)                          batch statistics over all B T rows
    y  = dropout(swish(cn) W2^T + b2)

Train-mode BatchNorm makes the forward two passes (`conv_stats_*`: the
per-channel sums s1, s2 of c; `conv_fwd_*`: normalise with the batch mean and
rstd and finish the module) and the backward two more (`conv_bwd1_*`: the pw2
gradients and the two BN reductions r1 = sum gbn, r2 = sum gbn chat;
`conv_bwd2_*`: dx and the remaining gradients), with the (E,)-sized glue of
pallas_conv_module.py:353-355 and :418-419 between them. Every pass
recomputes the forward from x: only x, the parameters, the seed and the batch
statistics cross from forward to backward.

`fused_conv_module_3d_dp` is the data-parallel form (K3dp): the same passes
on each rank's shard, the (E,)-sized sums all-reduced between them.

`fused_conv_module_3d` runs each pass as the hand-written CUDA kernel of
`csrc/conv_module.cu` for CUDA tensors and as its plain version
(`conv_*_reference`) for CPU tensors. The stats pass sums s1 and s2 in a
fixed order in both types, and in bf16 both backward passes sum every
gradient so too (no atomics): from the same inputs they give the same bits.
The fp32 backward's sums are added with atomics. The backward is the JAX custom VJP
written out, not autograd of the forward: it ignores the cotangents of the
batch mean and variance, returns a zero depthwise-bias gradient (train-mode
BN subtracts the batch mean) and the BN gradients as sums (d bn_w = r2,
d bn_b = r1). Parameters keep the port's `Conv` layout, pw1 (2E, d, 1),
depthwise (E, 1, k), pw2 (E', E, 1); the GLU halves are rows [:E] and [E:]
of pw1.

Rounding follows the TPU kernel: h = round(xhat) * round(ln_w) + round(ln_b)
in x's dtype; a and bg rounded after their fp32 bias; the gate in fp32 on the
rounded bg; z rounded; depthwise taps in fp32 with the fp32 tap weights, c
rounded, then + round(b_dw) in x's dtype; BN in fp32, cn rounded; swish in
fp32, s rounded; pw2 in fp32 + b2, dropout in fp32, y rounded. In the
backward the operands of dW2, ds, dW1 and dh are rounded to x's dtype; gbn,
dc, dz, da, dbg and the LayerNorm backward (with the unrounded xhat and the
fp32 ln_w) stay fp32. Dropout multiplies y in the forward and g in both
backward passes by the counter-hash mask of `ops/ffn.py:dropout_mask` with one
tile per sequence (pallas_conv_module.py:72-87).
"""

import ctypes
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.ffn import _M32, _threshold, dropout_mask, shard_seed

KERNEL_STATS = "fused_conv_stats"
KERNEL_FWD = "fused_conv_fwd"
KERNEL_BWD1 = "fused_conv_bwd1"
KERNEL_BWD2 = "fused_conv_bwd2"
KERNELS = (KERNEL_STATS, KERNEL_FWD, KERNEL_BWD1, KERNEL_BWD2)
# the same four passes on the data-parallel path (K3dp), counted apart
KERNELS_DP = ("fused_conv_dp_stats", "fused_conv_dp_fwd", "fused_conv_dp_bwd1",
              "fused_conv_dp_bwd2")
MAX_DIM = 384                      # widest d, E, E' the kernels take
MAX_K = 31                         # longest depthwise kernel they take

PARAM_NAMES = ("ln_w", "ln_b", "pw1_w", "pw1_b", "dw_w", "dw_b", "bn_w",
               "bn_b", "pw2_w", "pw2_b")


def pad_lo_for(padding: str, k: int) -> int:
    """Zeros before a sequence in the depthwise conv (ops/layers.conv_padding):
    (k-1)//2 for "same", k-1 for "causal"."""
    if padding == "same":
        return (k - 1) // 2
    if padding == "causal":
        return k - 1
    raise ValueError(f"fused conv module: unsupported padding {padding!r}")


def batch_stats(s1, s2, n: int, bn_eps: float):
    """(mean, biased var, rstd) from the per-channel sums over n rows."""
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var, torch.rsqrt(var + bn_eps)


def _r(a, cdt):
    """`a` rounded to `cdt`, kept in fp32."""
    return a.to(cdt).float()


def _mask(x, eo, seed, drop_rate):
    """(B, T, E') dropout multipliers of the hash, one tile per sequence, or
    None when dropout is off."""
    if drop_rate <= 0.0:
        return None
    b, t, _ = x.shape
    return dropout_mask(seed, b * t, eo, 1, 1.0 - drop_rate, x.device,
                        tile_rows=t).reshape(b, t, eo)


def _pre_bn(x, params, pad_lo: int, ln_eps: float):
    """The shared recompute up to the depthwise-conv output
    (pallas_conv_module.py:90-117), all fp32 tensors holding values of x's
    dtype where the TPU kernel holds that dtype."""
    ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b = params[:6]
    cdt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + ln_eps)
    xhat = (xf - mean) * rstd
    h = (xhat.to(cdt) * ln_w.to(cdt) + ln_b.to(cdt)).float()
    e = pw1_w.shape[0] // 2
    w1 = _r(pw1_w[:, :, 0], cdt)
    a = _r(h @ w1[:e].t() + pw1_b[:e], cdt)
    bg = _r(h @ w1[e:].t() + pw1_b[e:], cdt)
    gate = torch.sigmoid(bg)
    z = _r(a * gate, cdt)
    k, t = dw_w.shape[-1], x.shape[1]
    zp = F.pad(z, (0, 0, pad_lo, k - 1 - pad_lo))
    c = torch.zeros_like(z)
    for j in range(k):
        c = c + zp[:, j:j + t] * dw_w[:, 0, j]
    c = (c.to(cdt) + dw_b.to(cdt)).float()
    return {"h": h, "xhat": xhat, "rstd": rstd, "a": a, "gate": gate, "z": z,
            "c": c}


def _bn_swish(c, mean, rstd, bn_w, bn_b, cdt):
    """BN apply in fp32 with the batch statistics, swish on the rounded
    result (pallas_conv_module.py:134-142): (chat, cn, sig, s)."""
    chat = (c - mean) * rstd
    cn = _r(chat * bn_w + bn_b, cdt)
    sig = torch.sigmoid(cn)
    return chat, cn, sig, _r(cn * sig, cdt)


def conv_stats_reference(x, params, pad_lo: int, ln_eps: float = 1e-6):
    """Plain K3-stats: per-channel fp32 sum and sum of squares of c over all
    B T rows."""
    c = _pre_bn(x, params, pad_lo, ln_eps)["c"]
    return c.sum(dim=(0, 1)), (c * c).sum(dim=(0, 1))


def conv_fwd_reference(x, params, mean, rstd, seed: int, pad_lo: int,
                       ln_eps: float = 1e-6, drop_rate: float = 0.0):
    """Plain K3-fwd: y (B, T, E') in x's dtype."""
    cdt = x.dtype
    c = _pre_bn(x, params, pad_lo, ln_eps)["c"]
    s = _bn_swish(c, mean, rstd, params[6], params[7], cdt)[3]
    pw2_w, pw2_b = params[8], params[9]
    y = s @ _r(pw2_w[:, :, 0], cdt).t() + pw2_b
    mask = _mask(x, pw2_w.shape[0], seed, drop_rate)
    if mask is not None:
        y = y * mask
    return y.to(cdt)


def _grad_bn_in(x, g, params, mean, rstd, seed, pad_lo, ln_eps, drop_rate):
    """Recompute, mask g, and take the gradient to the BN output's input
    side: (pre-BN tensors, chat, s, g * mask, rounded g * mask, gbn)."""
    cdt = x.dtype
    pre = _pre_bn(x, params, pad_lo, ln_eps)
    chat, cn, sig, s = _bn_swish(pre["c"], mean, rstd, params[6], params[7],
                                 cdt)
    gm = g.float()
    mask = _mask(x, params[8].shape[0], seed, drop_rate)
    if mask is not None:
        gm = gm * mask
    gr = _r(gm, cdt)
    ds = gr @ _r(params[8][:, :, 0], cdt)
    gbn = ds * (sig + cn * sig * (1.0 - sig))
    return pre, chat, s, gm, gr, gbn


def conv_bwd1_reference(x, g, params, mean, rstd, seed: int, pad_lo: int,
                        ln_eps: float = 1e-6, drop_rate: float = 0.0):
    """Plain K3b-1: (dW2 (E', E), db2 (E',), r1 (E,), r2 (E,)), fp32."""
    _, chat, s, gm, gr, gbn = _grad_bn_in(x, g, params, mean, rstd, seed,
                                          pad_lo, ln_eps, drop_rate)
    dw2 = torch.einsum("bto,bte->oe", gr, s)
    return (dw2, gm.sum(dim=(0, 1)), gbn.sum(dim=(0, 1)),
            (gbn * chat).sum(dim=(0, 1)))


def conv_bwd2_reference(x, g, params, mean, rstd, rn1, rn2, seed: int,
                        pad_lo: int, ln_eps: float = 1e-6,
                        drop_rate: float = 0.0):
    """Plain K3b-2 from rn1 = r1 / n and rn2 = r2 / n: dx in x's dtype and
    the fp32 gradients of ln_w, ln_b, pw1 (2E, d), pw1_b (2E,) and the
    depthwise weight (E, k)."""
    cdt = x.dtype
    pre, chat, _, _, _, gbn = _grad_bn_in(x, g, params, mean, rstd, seed,
                                          pad_lo, ln_eps, drop_rate)
    ln_w, pw1_w, dw_w, bn_w = params[0], params[2], params[4], params[6]
    dc = bn_w * rstd * (gbn - rn1 - chat * rn2)
    k, t = dw_w.shape[-1], x.shape[1]
    pad_hi = k - 1 - pad_lo
    zp = F.pad(pre["z"], (0, 0, pad_lo, pad_hi))
    ddw = torch.stack([(zp[:, j:j + t] * dc).sum(dim=(0, 1))
                       for j in range(k)], dim=1)
    dcp = F.pad(dc, (0, 0, pad_hi, pad_lo))
    dz = torch.zeros_like(dc)
    for j in range(k):
        dz = dz + dcp[:, k - 1 - j:k - 1 - j + t] * dw_w[:, 0, j]
    gate = pre["gate"]
    da = dz * gate
    dbg = dz * pre["a"] * gate * (1.0 - gate)
    dab = _r(torch.cat([da, dbg], dim=-1), cdt)
    dw1 = torch.einsum("bte,btc->ec", dab, pre["h"])
    dh = dab @ _r(pw1_w[:, :, 0], cdt)
    xhat = pre["xhat"]
    dxhat = dh * ln_w
    dx = pre["rstd"] * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                        - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return (dx.to(cdt), (dh * xhat).sum(dim=(0, 1)), dh.sum(dim=(0, 1)), dw1,
            torch.cat([da.sum(dim=(0, 1)), dbg.sum(dim=(0, 1))]), ddw)


def _lib():
    lib = _cuda.library("conv_module")
    fns = (lib.avec_conv_stats, lib.avec_conv_fwd, lib.avec_conv_bwd1,
           lib.avec_conv_bwd2)
    size = lib.avec_conv_scratch_bytes
    if size.argtypes is None:
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        tail = [ci] * 7 + [cf, ci, cu, cu, cf, ci, vp]
        # pointer arguments: stats x, params, s1, s2, scratch; fwd x, params,
        # mean, rstd, y, scratch; bwd1 x, g, params, mean, rstd, dw2, db2,
        # r1, r2, scratch; bwd2 x, g, params, mean, rstd, rn1, rn2, dx,
        # grads, scratch
        for fn, n_ptr in zip(fns, (5, 6, 10, 10)):
            fn.argtypes = [vp] * n_ptr + tail
            fn.restype = ci
        size.argtypes = [ci] * 8
        size.restype = ctypes.c_longlong
    return fns, size


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(a.data_ptr() for a in tensors))


def _check(x, params):
    """(b, t, d, e, eo, k) of a CUDA call, or ValueError."""
    req = _cuda.require
    req(x.ndim == 3, f"x must be (B, T, d), got {tuple(x.shape)}")
    b, t, d = x.shape
    req(x.is_cuda and all(p.device == x.device for p in params),
        "x and the parameters must share one CUDA device")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"x must be fp32 or bf16, got {x.dtype}")
    req(all(p.dtype == torch.float32 and p.is_contiguous() for p in params),
        "parameters must be contiguous fp32 tensors")
    req(x.is_contiguous(), "x must be contiguous")
    e2, k, eo = params[2].shape[0], params[4].shape[-1], params[8].shape[0]
    e = e2 // 2
    shapes = [(d,), (d,), (2 * e, d, 1), (2 * e,), (e, 1, k), (e,), (e,),
              (e,), (eo, e, 1), (eo,)]
    req(e2 % 2 == 0 and [tuple(p.shape) for p in params] == shapes,
        f"parameter shapes do not fit x {tuple(x.shape)}: pw1 (2E, d, 1), "
        "depthwise (E, 1, k), pw2 (E', E, 1) and their vectors")
    req(b * t > 0 and max(d, e, eo) <= MAX_DIM and min(d, e, eo) > 0
        and 0 < k <= MAX_K,
        f"widths (d, E, E') = ({d}, {e}, {eo}) and k = {k} are outside the "
        f"kernels' range (at most {MAX_DIM}, k at most {MAX_K})")
    return b, t, d, e, eo, k


def _all_reduce_pair(a, b, group):
    """(a, b) summed over the ranks of `group` in one collective."""
    v = torch.cat([a, b])
    dist.all_reduce(v, group=group)
    return v[:a.shape[0]], v[a.shape[0]:]


class _FusedConvModule(torch.autograd.Function):
    """The two forward passes and the two backward passes, each a kernel for
    CUDA tensors and a plain stage for CPU tensors (or with use_kernel off).
    Only x, the parameters, the seed and the batch mean and rstd are kept for
    the backward, which recomputes the rest.

    With a process `group` (the K3dp path, pallas_conv_module.py:516-730) x
    is this rank's shard of the batch: s1, s2 are summed over the ranks
    before the statistics are formed over the global row count, and r1, r2
    before the second backward pass; every gradient returned is this rank's
    partial sum, the BN ones the local r2 and r1 (:715-719), so the gradient
    all-reduce of the train step sums each exactly once."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b, bn_w, bn_b,
                pw2_w, pw2_b, seed, pad_lo, ln_eps, bn_eps, drop_rate,
                use_kernel, group):
        params = tuple(p.detach() for p in (ln_w, ln_b, pw1_w, pw1_b, dw_w,
                                            dw_b, bn_w, bn_b, pw2_w, pw2_b))
        x = x.detach()
        b, t = x.shape[:2]
        n = b * t
        kernel = use_kernel and x.device.type != "cpu"
        names = KERNELS if group is None else KERNELS_DP
        if kernel:
            call = _Launch(x, params, seed, pad_lo, ln_eps, drop_rate, names)
            s1, s2 = call.stats()
        else:
            s1, s2 = conv_stats_reference(x, params, pad_lo, ln_eps)
        if group is not None:
            s1, s2 = _all_reduce_pair(s1, s2, group)
            n *= dist.get_world_size(group)
        mean, var, rstd = batch_stats(s1, s2, n, bn_eps)
        if kernel:
            y = call.fwd(mean, rstd)
        else:
            y = conv_fwd_reference(x, params, mean, rstd, seed, pad_lo,
                                   ln_eps, drop_rate)
        ctx.save_for_backward(x, mean, rstd, *params)
        ctx.conf = (seed, pad_lo, ln_eps, drop_rate, kernel, group, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, mean, rstd, *params = ctx.saved_tensors
        seed, pad_lo, ln_eps, drop_rate, kernel, group, n = ctx.conf
        g = g.to(x.dtype).contiguous()
        if kernel:
            names = KERNELS if group is None else KERNELS_DP
            call = _Launch(x, params, seed, pad_lo, ln_eps, drop_rate, names)
            dw2, db2, r1, r2 = call.bwd1(g, mean, rstd)
        else:
            dw2, db2, r1, r2 = conv_bwd1_reference(
                x, g, params, mean, rstd, seed, pad_lo, ln_eps, drop_rate)
        r1g, r2g = (r1, r2) if group is None else _all_reduce_pair(r1, r2,
                                                                  group)
        if kernel:
            dx, dln_w, dln_b, dw1, db1, ddw = call.bwd2(g, mean, rstd, r1g / n,
                                                        r2g / n)
        else:
            dx, dln_w, dln_b, dw1, db1, ddw = conv_bwd2_reference(
                x, g, params, mean, rstd, r1g / n, r2g / n, seed, pad_lo,
                ln_eps, drop_rate)
        grads = (dln_w, dln_b, dw1.reshape(params[2].shape), db1,
                 ddw.reshape(params[4].shape), torch.zeros_like(params[5]),
                 r2, r1, dw2.reshape(params[8].shape), db2)
        return (dx, *grads) + (None,) * 7


class _Launch:
    """The four C entry points of `csrc/conv_module.cu` for one call's
    input and parameters; each method allocates its outputs (accumulators
    zeroed on the current stream) and a scratch buffer that lives until it
    returns, launches, and counts one launch under its name in `names`
    (KERNELS, or KERNELS_DP on the data-parallel path). No entry point reads
    the row count for a global quantity: the statistics and r1 / n, r2 / n
    come in from the caller."""

    def __init__(self, x, params, seed, pad_lo, ln_eps, drop_rate,
                 names=KERNELS):
        b, t, d, e, eo, k = _check(x, params)
        self.x, self.params, self.ptrs = x, params, _pointers(params)
        self.dims = (b, t, d, e, eo, k)
        self.names = names
        drop = bool(drop_rate > 0.0)
        thr, inv_keep = _threshold(1.0 - drop_rate) if drop else (0, 1.0)
        self.tail = (b, t, d, e, eo, k, pad_lo, float(ln_eps), int(drop),
                     int(seed) & _M32, thr, inv_keep,
                     int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))
        self.fns, self.size = _lib()

    def scratch(self, stage: int) -> torch.Tensor:
        """The byte buffer pass `stage` (0 stats .. 3 bwd2) needs."""
        size = self.size(*self.dims, stage,
                         int(self.x.dtype == torch.bfloat16))
        return torch.empty(size, dtype=torch.uint8, device=self.x.device)

    def _run(self, stage: int, *ptrs):
        scratch = self.scratch(stage)
        with _cuda.launch(self.names[stage]):
            rc = self.fns[stage](*ptrs, scratch.data_ptr(), *self.tail)
            _cuda.check(rc, self.names[stage])

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float32, device=self.x.device)

    def stats(self):
        e = self.dims[3]
        s1, s2 = self._zeros(e), self._zeros(e)
        self._run(0, self.x.data_ptr(), self.ptrs,
                  s1.data_ptr(), s2.data_ptr())
        return s1, s2

    def fwd(self, mean, rstd):
        b, t, _, _, eo, _ = self.dims
        y = torch.empty((b, t, eo), dtype=self.x.dtype, device=self.x.device)
        self._run(1, self.x.data_ptr(), self.ptrs,
                  mean.data_ptr(), rstd.data_ptr(), y.data_ptr())
        return y

    def bwd1(self, g, mean, rstd):
        e, eo = self.dims[3], self.dims[4]
        dw2, db2 = self._zeros(eo, e), self._zeros(eo)
        r1, r2 = self._zeros(e), self._zeros(e)
        self._run(2, self.x.data_ptr(), g.data_ptr(), self.ptrs,
                  mean.data_ptr(), rstd.data_ptr(), dw2.data_ptr(),
                  db2.data_ptr(), r1.data_ptr(), r2.data_ptr())
        return dw2, db2, r1, r2

    def bwd2(self, g, mean, rstd, rn1, rn2):
        _, _, d, e, _, k = self.dims
        dx = torch.empty_like(self.x)
        grads = [self._zeros(d), self._zeros(d), self._zeros(2 * e, d),
                 self._zeros(2 * e), self._zeros(e, k)]
        self._run(3, self.x.data_ptr(), g.data_ptr(), self.ptrs,
                  mean.data_ptr(), rstd.data_ptr(), rn1.data_ptr(),
                  rn2.data_ptr(), dx.data_ptr(), _pointers(grads))
        return (dx, *grads)


def fused_conv_module_3d(x, ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b, bn_w, bn_b,
                         pw2_w, pw2_b, *, seed: Optional[int] = None,
                         padding: str = "same", ln_eps: float = 1e-6,
                         bn_eps: float = 1e-5, drop_rate: float = 0.0,
                         deterministic: bool = True, use_kernel: bool = True):
    """Fused stride-1 convolution module on (B, T, d)
    (pallas_conv_module.py:479): returns (y (B, T, E'), batch mean (E,),
    biased batch variance (E,)), the statistics for the running update.

    `seed` is a 31-bit integer, read only when training with dropout
    (deterministic=False and drop_rate > 0). CPU tensors take the plain
    stages; CUDA tensors launch the kernels, in the backward too, and raise
    on what the kernels do not take. use_kernel=False runs the plain stages
    on any device."""
    k = dw_w.shape[-1]
    rate = float(drop_rate) if not deterministic else 0.0
    return _FusedConvModule.apply(
        x.contiguous(), ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b, bn_w, bn_b,
        pw2_w, pw2_b, 0 if seed is None else int(seed),
        pad_lo_for(padding, k), float(ln_eps), float(bn_eps), rate,
        bool(use_kernel), None)


def fused_conv_module_3d_dp(x, ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b, bn_w,
                            bn_b, pw2_w, pw2_b, *, group=None,
                            seed: Optional[int] = None, padding: str = "same",
                            ln_eps: float = 1e-6, bn_eps: float = 1e-5,
                            drop_rate: float = 0.0, deterministic: bool = True,
                            use_kernel: bool = True):
    """The K3dp path (pallas_conv_module.py:516): x is this rank's shard
    (B_r, T, d) of a batch split over the ranks of `group` (None: the
    default group), the parameters are replicated. The same four passes as
    `fused_conv_module_3d` on each rank, with the batch sums all-reduced
    between the statistics and forward passes and the two BN reductions
    between the backward passes, so the statistics are those of the global
    B_r T world rows. Returns (y (B_r, T, E'), global batch mean, global
    biased batch variance); the gradients are this rank's partial sums. The
    dropout seed is offset per rank as the JAX wrapper does (:543), at
    world size 1 too. Each rank launches each pass once per forward and
    backward, counted under KERNELS_DP."""
    group = group if group is not None else dist.group.WORLD
    k = dw_w.shape[-1]
    rate = float(drop_rate) if not deterministic else 0.0
    return _FusedConvModule.apply(
        x.contiguous(), ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b, bn_w, bn_b,
        pw2_w, pw2_b, shard_seed(seed, dist.get_rank(group)),
        pad_lo_for(padding, k), float(ln_eps), float(bn_eps), rate,
        bool(use_kernel), group)


def conv_module_params(module) -> Sequence[torch.Tensor]:
    """The ten parameters of a port `ConvolutionModule`, in the order of
    `fused_conv_module_3d`."""
    ln, pw1, dw, bn, pw2 = (module.layers[k] for k in ("0", "1", "3", "4",
                                                       "6"))
    return (ln.weight, ln.bias, pw1.weight, pw1.bias, dw.weight, dw.bias,
            bn.weight, bn.bias, pw2.weight, pw2.bias)
