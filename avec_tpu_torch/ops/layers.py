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

`ConvTranspose`, `GroupNorm` and `InstanceNorm` take channels-first tensors
as `Conv` and `BatchNorm` do; `LSTM` and the global pools work on
(B, ..., C) as the JAX layers do. `weight_init` / `bias_init` name an
initializer of `ops/inits.py`, drawn from the generator of `init_params`.
"""

import contextlib
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from avec_tpu_torch.ops.inits import get_init, torch_default_bias
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


def _init_bias(bias, bias_init, fan_in: int, gen) -> None:
    """A bias from its registry name; "default" is torch's U(+-1/sqrt(fan_in))
    of the layer's weight fan_in."""
    if bias is not None:
        (torch_default_bias(fan_in) if bias_init in (None, "default")
         else get_init(bias_init))(bias, gen)


class Linear(nn.Module):
    """Dense layer over the last axis. Init: `weight_init` / `bias_init`
    registry names (`ops/inits.py`): torch-default ("default"), or e.g. the
    GPT's N(0, 0.02) weights ("normal_02") and zero biases ("zeros").
    `dtype` (None: x's) is the dtype x is cast to before the product, whose
    kernel is cast to x's own dtype (layers.py:88-95): the product runs in
    the wider of the two."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init: str = "default", bias_init: str = "default",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.weight_init, self.bias_init = weight_init, bias_init
        self.dtype = dtype

    def init_(self, gen: torch.Generator):
        get_init(self.weight_init)(self.weight, gen)
        _init_bias(self.bias, self.bias_init, self.weight.shape[1], gen)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.dtype is not None:
            ct = torch.promote_types(self.dtype, x.dtype)
            x, w = x.to(self.dtype).to(ct), w.to(ct)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w, b)


class Conv(nn.Module):
    """N-d convolution (N, C, *spatial) with the reference padding policies.
    `weight_init` None: bias-free convs (the ResNet trunk) init he-normal,
    others torch-default. bias_stop_gradient detaches the bias in training
    mode (layers.py:265). `kernel_mask` is a fixed mask of the JAX kernel
    layout (*kernel, 1 or in, 1 or out), e.g. `pixelcnn_mask`, multiplied
    into the weight at every call (layers.py:226-228)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, ndim: int = 1,
                 stride=1, padding: PaddingLike = "same", groups: int = 1,
                 bias: bool = True, bias_stop_gradient: bool = False,
                 weight_init: Optional[str] = None,
                 bias_init: str = "default", kernel_mask=None):
        super().__init__()
        self.weight_init = (weight_init if weight_init is not None
                            else ("default" if bias else "he_normal"))
        self.bias_init = bias_init
        if kernel_mask is not None:
            m = np.asarray(kernel_mask, np.float32)
            m = m.transpose((ndim + 1, ndim) + tuple(range(ndim)))
            self.register_buffer("kernel_mask", torch.from_numpy(
                np.ascontiguousarray(m)), persistent=False)
        else:
            self.kernel_mask = None
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
        get_init(self.weight_init)(self.weight, gen)
        _init_bias(self.bias, self.bias_init, self.weight[0].numel(), gen)

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
        w = self.weight
        if self.kernel_mask is not None:
            w = w * self.kernel_mask
        return conv(x, w.to(x.dtype), b, stride=self.stride,
                    padding=padding, groups=self.groups)


class ConvTranspose(nn.Module):
    """N-d transposed convolution (N, C, *spatial) (layers.py:328-370):
    output length (T - 1) * s - 2 p + k + output_padding per axis. The
    weight has torch's (in, out, *kernel) layout: the JAX layer's kernel
    K (*kernel, in, out), flipped and run as a convolution over the
    s-dilated input padded (k - 1 - p, k - 1 - p + output_padding), is this
    layer with weight[i, o, *j] = K[*j, i, o]. Fans (for `weight_init`) and
    the default bias bound are those of the JAX kernel: fan_in =
    in * prod(kernel)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, ndim: int = 1,
                 stride=1, padding=0, output_padding=0, bias: bool = True,
                 weight_init: str = "default", bias_init: str = "default"):
        super().__init__()
        self.ndim = ndim
        self.kernel_size = _tuple(kernel_size, ndim)
        self.stride = _tuple(stride, ndim)
        self.padding = _tuple(padding, ndim)
        self.output_padding = _tuple(output_padding, ndim)
        self.weight = nn.Parameter(
            torch.empty((in_ch, out_ch) + self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.weight_init, self.bias_init = weight_init, bias_init

    def init_(self, gen: torch.Generator):
        receptive = math.prod(self.kernel_size)
        fans = (self.weight.shape[0] * receptive,
                self.weight.shape[1] * receptive)
        get_init(self.weight_init)(self.weight, gen, fans=fans)
        _init_bias(self.bias, self.bias_init, fans[0], gen)

    def forward(self, x):
        conv = (F.conv_transpose1d, F.conv_transpose2d,
                F.conv_transpose3d)[self.ndim - 1]
        b = None if self.bias is None else self.bias.to(x.dtype)
        return conv(x, self.weight.to(x.dtype), b, stride=self.stride,
                    padding=self.padding, output_padding=self.output_padding)


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


def global_avg_pool(x, axes=None):
    """Mean over the spatial axes of a channels-last (B, *spatial, C)
    tensor, or over `axes` (layers.py:467-471)."""
    if axes is None:
        axes = tuple(range(1, x.ndim - 1))
    return x.mean(dim=axes)


def global_max_pool(x, axes=None):
    """Max over the spatial axes of a channels-last (B, *spatial, C) tensor,
    or over `axes` (layers.py:474-478)."""
    if axes is None:
        axes = tuple(range(1, x.ndim - 1))
    return torch.amax(x, dim=axes)


def pixelcnn_mask(kernel_size: Sequence[int], mask_type: str = "A"
                  ) -> np.ndarray:
    """PixelCNN causal kernel mask (layers.py:481-491), shape (*kernel, 1,
    1): ones before the centre tap in raster order, the centre itself
    included for type "B", zeros after."""
    ks = tuple(kernel_size)
    mask = np.ones(ks, dtype=np.float32)
    flat = mask.reshape(-1)
    centre = int(np.ravel_multi_index([k // 2 for k in ks], ks))
    flat[centre if mask_type == "A" else centre + 1:] = 0.0
    return mask.reshape(ks + (1, 1))


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


_running_held = [0]


@contextlib.contextmanager
def running_statistics_held():
    """Inside, no BatchNorm moves its running statistics: a rematerialized
    block's recompute replays a forward whose update is already made."""
    _running_held[0] += 1
    try:
        yield
    finally:
        _running_held[0] -= 1


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1 (layers.py:537); the normalise-and-affine
    runs in fp32 and is rounded to x's dtype.

    Eval, and training with `frozen` (layers.py:541-557), use the running
    statistics. Training otherwise uses the batch's: one pass
    E[x^2] - E[x]^2 in fp32, clamped at 0, differentiated through; the
    running statistics move by `momentum` (0.1, flax 0.9) towards the batch
    mean and the unbiased batch variance. With a `process_group` (set by the
    model's `set_data_parallel`) the statistics are those of the global
    batch over the group's ranks (`sync_moments`), as GSPMD computes them
    for a sharded batch (layers.py:23-26, :712-714); without one the
    arithmetic is the single-process one."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, frozen: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.frozen = frozen
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
        the unbiased form of a (biased) batch variance over n positions;
        nothing inside `running_statistics_held`."""
        if _running_held[0]:
            return
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m * n / max(n - 1, 1))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if self.training and not self.frozen:
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


class GroupNorm(nn.Module):
    """Group normalisation over channel axis 1 (flax's `nn.GroupNorm`,
    which layers.py:610-618 wraps): the channels split into `num_groups`
    contiguous groups, statistics per sample and group over the group's
    channels and every spatial position, in fp32, the variance as E[x^2] -
    E[x]^2 clamped at 0; scale and bias per channel."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 epsilon: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_channels} channels")
        self.num_groups, self.eps = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def init_(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        n, c = x.shape[:2]
        xf = x.float().reshape(n, self.num_groups, -1)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        return (y * self.weight.view(shape)
                + self.bias.view(shape)).to(x.dtype)


class InstanceNorm(nn.Module):
    """Instance normalisation over channel axis 1 (layers.py:621-641):
    statistics per sample and channel over the spatial axes, in fp32
    (two-pass variance); with `affine`, a scale and bias per channel
    (`num_features` of them)."""

    def __init__(self, num_features: Optional[int] = None,
                 epsilon: float = 1e-5, affine: bool = False):
        super().__init__()
        self.eps, self.affine = epsilon, affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def init_(self, gen: torch.Generator):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        axes = tuple(range(2, x.ndim))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            shape = (1, -1) + (1,) * (x.ndim - 2)
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


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
    at init from `embedding_init` (a registry name; None: N(0, 1), as the
    JAX layer; the GPT's is "normal_02") with the `padding_idx` row zero.
    The pad row is gathered like any other and takes its gradient, as the
    JAX gather does (no `padding_idx` in `F.embedding`)."""

    def __init__(self, num_embeddings: int, features: int, padding_idx=None,
                 embedding_init: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.padding_idx = padding_idx
        self.embedding_init = embedding_init

    def init_(self, gen: torch.Generator):
        # the JAX table is (num_embeddings, features) as here: its fans
        get_init(self.embedding_init, default="normal")(
            self.weight, gen, fans=tuple(self.weight.shape))
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx].zero_()

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LSTM(nn.LSTM):
    """Multi-layer, optionally bidirectional LSTM over (B, T, D) (layers.py:
    681-705: flax's `OptimizedLSTMCell` under `nn.RNN`), returning the last
    layer's outputs (B, T, H or 2H). The gates are i, f, g, o, as torch's;
    the JAX input kernels have no bias, so `bias_ih_l{k}` stays zero where
    `params_from_jax` carries a JAX LSTM; the reverse direction keeps the
    time order, and the directions are concatenated forward first. Init as
    the JAX cell: input weights LeCun-normal, recurrent weights orthogonal
    per gate, biases zero. Runs in fp32 and returns x's dtype."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, batch_first=True)

    def init_(self, gen: torch.Generator):
        h = self.hidden_size
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("weight_ih"):
                    p.normal_(0.0, math.sqrt(1.0 / p.shape[1]), generator=gen)
                elif name.startswith("weight_hh"):
                    for gate in range(4):
                        nn.init.orthogonal_(p[gate * h:(gate + 1) * h],
                                            generator=gen)
                else:
                    p.zero_()

    def forward(self, x):
        return super().forward(x.float())[0].to(x.dtype)


# channels-first norms take their channel count first; LayerNorm normalises
# the last axis (layers.py:707-719)
norm_dict = {
    "LayerNorm": LayerNorm,
    "BatchNorm1d": BatchNorm,
    "BatchNorm2d": BatchNorm,
    "BatchNorm3d": BatchNorm,
    "SyncBatchNorm": BatchNorm,
    "GroupNorm": GroupNorm,
    "InstanceNorm2d": InstanceNorm,
    "InstanceNorm3d": InstanceNorm,
    None: None,
}

# layers.py:721-734: the layer classes named in block configs
layer_dict = {
    "Linear": Linear,
    "Conv1d": lambda *a, **k: Conv(*a, ndim=1, **k),
    "Conv2d": lambda *a, **k: Conv(*a, ndim=2, **k),
    "Conv3d": lambda *a, **k: Conv(*a, ndim=3, **k),
    "ConvTranspose1d": lambda *a, **k: ConvTranspose(*a, ndim=1, **k),
    "ConvTranspose2d": lambda *a, **k: ConvTranspose(*a, ndim=2, **k),
    "ConvTranspose3d": lambda *a, **k: ConvTranspose(*a, ndim=3, **k),
    "LSTM": LSTM,
    "Embedding": Embedding,
    "Dropout": Dropout,
}


def init_params(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `gen` (torch-default inits)."""
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return module
