"""Layer library (port of avec_tpu/ops/layers.py), eval and training.

Parameters keep the reference PyTorch layouts and names (Linear weight
(O, I), Conv weight (O, I/groups, *k), norm weight/bias, BN running stats),
so the reference state_dict and `avec_tpu_torch.convert` share one map.
Parameters stay fp32 and are cast to the activation dtype inside each op.

Layouts: `Conv` and `BatchNorm` take channels-first tensors (N, C, *spatial)
as PyTorch does; `Linear`, `LayerNorm` and the pooling helpers work on the
last axis / channels-last tensors, as the JAX package does. The JAX
`_polyphase_fold`/`_polyphase_conv` are TPU layout tricks with identical
outputs: here a plain `F.conv{1,2,3}d` with the same padding.

Every layer is built in eval mode (unlike `nn.Module`'s default), as the JAX
layers default to `deterministic=True`; call `.train()` on the model for
training. Training mode follows `nn.Module.train()`: `BatchNorm` normalises
with batch statistics and updates its running statistics, `Dropout` draws its
mask from an explicit `torch.Generator`, and a `Conv(bias_stop_gradient=True)`
feeding a train-mode BatchNorm detaches its bias, whose gradient is
analytically zero (autograd alone leaves rounding noise there, which Adam's
first step would turn into a full lr-sized move).
"""

import math
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from avec_tpu_torch.parallel.dist import all_reduce_sum

PaddingLike = Union[str, int, Sequence]


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        assert len(v) == n
        return tuple(v)
    return (v,) * n


def conv_padding(kernel_size: Tuple[int, ...], padding: PaddingLike):
    """Reference padding policy -> explicit (lo, hi) pairs per axis:
    same = ((k-1)//2, k//2), same-left = (k//2, (k-1)//2), causal = (k-1, 0)."""
    n = len(kernel_size)
    if isinstance(padding, str):
        rule = {"valid": lambda k: (0, 0),
                "same": lambda k: ((k - 1) // 2, k // 2),
                "same-left": lambda k: (k // 2, (k - 1) // 2),
                "causal": lambda k: (k - 1, 0)}
        if padding not in rule:
            raise ValueError(f"unknown padding policy: {padding}")
        return tuple(rule[padding](k) for k in kernel_size)
    if (isinstance(padding, (tuple, list))
            and any(isinstance(p, str) for p in padding)):
        assert len(padding) == n
        return tuple(conv_padding((k,), p)[0]
                     for k, p in zip(kernel_size, padding))
    return tuple((p, p) for p in _tuple(padding, n))


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class Linear(nn.Module):
    """Dense layer over the last axis. Init: torch-default ("default"), or
    the GPT's N(0, 0.02) weights ("normal_02") and zero biases ("zeros")."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init: str = "default", bias_init: str = "default"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.weight_init, self.bias_init = weight_init, bias_init

    def init_(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            if self.weight_init == "normal_02":
                self.weight.normal_(0.0, 0.02, generator=gen)
            else:
                _uniform_(self.weight, bound, gen)
            if self.bias is not None:
                if self.bias_init == "zeros":
                    self.bias.zero_()
                else:
                    _uniform_(self.bias, bound, gen)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv(nn.Module):
    """N-d convolution (N, C, *spatial) with the reference padding policies.
    Bias-free convs (the ResNet trunk) init he-normal, others torch-default.
    bias_stop_gradient detaches the bias in training mode (layers.py:265)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, ndim: int = 1,
                 stride=1, padding: PaddingLike = "same", groups: int = 1,
                 bias: bool = True, bias_stop_gradient: bool = False):
        super().__init__()
        self.bias_stop_gradient = bias_stop_gradient
        self.ndim = ndim
        self.kernel_size = _tuple(kernel_size, ndim)
        self.stride = _tuple(stride, ndim)
        self.pads = conv_padding(self.kernel_size, padding)
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch // groups) + self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.training = False

    def init_(self, gen: torch.Generator):
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            if self.bias is None:
                self.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            else:
                _uniform_(self.weight, 1.0 / math.sqrt(fan_in), gen)
                _uniform_(self.bias, 1.0 / math.sqrt(fan_in), gen)

    def forward(self, x, pads=None):
        """`pads` ((lo, hi) per spatial axis) replaces the layer's padding
        for this call: the streaming step's carried tails take the place
        of the causal padding."""
        conv = (F.conv1d, F.conv2d, F.conv3d)[self.ndim - 1]
        pads = self.pads if pads is None else pads
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            flat = [p for pair in reversed(pads) for p in pair]
            x = F.pad(x, flat)
            padding = 0
        b = self.bias
        if b is not None:
            if self.bias_stop_gradient and self.training:
                b = b.detach()
            b = b.to(x.dtype)
        return conv(x, self.weight.to(x.dtype), b, stride=self.stride,
                    padding=padding, groups=self.groups)


def _to_channels_first(x):
    return x.movedim(-1, 1)


def _to_channels_last(x):
    return x.movedim(1, -1)


def max_pool(x, kernel_size, strides=None, padding: PaddingLike = "valid"):
    """Channels-last (B, *spatial, C) max pool; pads are -inf."""
    n = x.ndim - 2
    ks = _tuple(kernel_size, n)
    st = _tuple(strides if strides is not None else kernel_size, n)
    pads = conv_padding(ks, padding)
    y = _to_channels_first(x)
    if any(p != (0, 0) for p in pads):
        y = F.pad(y, [p for pair in reversed(pads) for p in pair],
                  value=float("-inf"))
    pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1]
    return _to_channels_last(pool(y, ks, st))


def avg_pool(x, kernel_size, strides=None, padding: PaddingLike = "valid"):
    """Channels-last average pool; zero pads count (torch default)."""
    n = x.ndim - 2
    ks = _tuple(kernel_size, n)
    st = _tuple(strides if strides is not None else kernel_size, n)
    pads = conv_padding(ks, padding)
    y = _to_channels_first(x)
    if any(p != (0, 0) for p in pads):
        y = F.pad(y, [p for pair in reversed(pads) for p in pair])
    pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[n - 1]
    return _to_channels_last(pool(y, ks, st))


def upsample_nearest(x, scale_factor: int, axis: int = 1):
    """Nearest-neighbour upsample along one axis."""
    return torch.repeat_interleave(x, scale_factor, dim=axis)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: fp32 stats, normalised value rounded to
    x's dtype before the affine (as the JAX `_ln_apply`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def sync_moments(mean, ex2, n: int, group):
    """Global per-channel E[x] and E[x^2] from each rank's over its n
    positions: one all-reduce of (n E[x], n E[x^2], n) in fp64 over `group`,
    differentiable (the backward sums the statistics' cotangents over the
    ranks, which carries the two BatchNorm reductions sum(g) and
    sum(g xhat)). Returns fp32 (mean, E[x^2]) and the global count, taken as
    n times the world size: `shard_batch` gives every rank the same number of
    positions. The products n E[x] are exact in fp64 below 2^29 positions,
    so one rank gets its own statistics back bit for bit."""
    c = mean.shape[0]
    count = torch.full((1,), float(n), dtype=torch.float64, device=mean.device)
    v = all_reduce_sum(torch.cat([mean.double() * n, ex2.double() * n,
                                  count]), group)
    total = v[2 * c:]
    return ((v[:c] / total).float(), (v[c:2 * c] / total).float(),
            n * dist.get_world_size(group))


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1 (layers.py:537); the normalise-and-affine
    runs in fp32 and is rounded to x's dtype.

    Eval uses the running statistics. Training uses the batch's: one pass
    E[x^2] - E[x]^2 in fp32, clamped at 0, differentiated through; the
    running statistics move by `momentum` (0.1, flax 0.9) towards the batch
    mean and the unbiased batch variance. With a `process_group` (set by the
    model's `set_data_parallel`) the statistics are those of the global
    batch over the group's ranks (`sync_moments`), as GSPMD computes them
    for a sharded batch (layers.py:23-26, :712-714); without one the
    arithmetic is the single-process one."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.process_group = None
        self.training = False

    def init_(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    @torch.no_grad()
    def update_running(self, mean, var, n: int) -> None:
        """Move the running statistics by `momentum` towards a batch mean and
        the unbiased form of a (biased) batch variance over n positions."""
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m * n / max(n - 1, 1))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if self.training:
            axes = (0,) + tuple(range(2, x.ndim))
            mean = xf.mean(dim=axes)
            ex2 = (xf * xf).mean(dim=axes)
            n = x.numel() // x.shape[1]
            if self.process_group is not None:
                mean, ex2, n = sync_moments(mean, ex2, n, self.process_group)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            self.update_running(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout (layers.py:666): in training mode keep each entry
    with probability 1 - rate and scale it by 1 / (1 - rate). The mask is
    drawn from `generator`, a `torch.Generator` on x's device that the owning
    model sets (None: the default generator). `regularize=False` turns the
    layer into the identity in training mode too."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.regularize = True
        self.generator = None
        self.training = False

    def forward(self, x):
        if not (self.training and self.regularize) or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class Embedding(nn.Module):
    """Token embedding (layers.py:643-663): a gather of `weight` rows, drawn
    N(0, 0.02) at init (the GPT's init, its only user) with the
    `padding_idx` row zero. The pad row is gathered like any other and
    takes its gradient, as the JAX gather does (no `padding_idx` in
    `F.embedding`)."""

    def __init__(self, num_embeddings: int, features: int, padding_idx=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.padding_idx = padding_idx

    def init_(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=gen)
            if self.padding_idx is not None:
                self.weight[self.padding_idx].zero_()

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def init_params(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `gen` (torch-default inits)."""
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return module
