"""ResNet family (port of avec_tpu/models/resnet.py), NCHW; its BatchNorms
use batch statistics in training mode, those of the global batch in
data-parallel training.

ResNet18 / 34 are basic blocks, ResNet50 / 101 / 152 bottleneck blocks
(resnet.py:29-40). AVEC uses ResNet18 without its stem as the per-frame
visual trunk (include_stem=False, dim_output=256, the head's
torch-default init). Convs are bias-free with "same" padding and he-normal
weights; the post-activation follows the residual add. Names follow the
reference: stem.{0 conv, 1 bn}, blocks.{i}.layers.{0 conv1, 1 bn1, 3 conv2,
4 bn2} (a bottleneck block adds 6 conv3, 7 bn3), blocks.{i}.residual.{0
conv, 1 bn}, head.1.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from avec_tpu_torch.ops.activations import get_act
from avec_tpu_torch.ops.layers import BatchNorm, Conv, Linear

_CONFIGS = {
    "ResNet18": dict(dim_stem=64, dim_blocks=(64, 128, 256, 512),
                     num_blocks=(2, 2, 2, 2), bottleneck=False),
    "ResNet34": dict(dim_stem=64, dim_blocks=(64, 128, 256, 512),
                     num_blocks=(3, 4, 6, 3), bottleneck=False),
    "ResNet50": dict(dim_stem=64, dim_blocks=(256, 512, 1024, 2048),
                     num_blocks=(3, 4, 6, 3), bottleneck=True),
    "ResNet101": dict(dim_stem=64, dim_blocks=(256, 512, 1024, 2048),
                      num_blocks=(3, 4, 23, 3), bottleneck=True),
    "ResNet152": dict(dim_stem=64, dim_blocks=(256, 512, 1024, 2048),
                      num_blocks=(3, 8, 36, 3), bottleneck=True),
}


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _residual(in_features, out_features, strides):
    if strides == (1, 1) and in_features == out_features:
        return None
    return nn.ModuleDict({
        "0": Conv(in_features, out_features, 1, ndim=2, stride=strides,
                  bias=False),
        "1": BatchNorm(out_features)})


def _join(block, bn, z, x):
    """The block's last BatchNorm `bn` on its last conv's output z, the
    residual add and the block's last activation. A ReLU block hands the add
    and the ReLU to the BatchNorm, whose training kernels apply them in the
    same pass."""
    res = x if block.residual is None else \
        block.residual["1"](block.residual["0"](x))
    if block.act is torch.relu:
        if block.joined_post_act:
            return bn(z, residual=res, relu=True)
        return bn(z, relu=True) + res
    y = bn(z)
    if not block.joined_post_act:
        y = block.act(y)
    out = y + res
    return block.act(out) if block.joined_post_act else out


def _bn_act(block, bn, z):
    """BatchNorm then the block's activation, a ReLU inside the BatchNorm."""
    if block.act is torch.relu:
        return bn(z, relu=True)
    return block.act(bn(z))


class ResNetBlock(nn.Module):
    """Basic residual block (resnet.py:43-76): two `kernel_size` convs (the
    first with the block's `strides`), each followed by BN, the activation
    `act_fun` after the first; with `joined_post_act` the second's
    activation follows the residual add, else it precedes it."""

    def __init__(self, in_features: int, out_features: int, strides=1,
                 kernel_size=3, act_fun: str = "ReLU",
                 joined_post_act: bool = True):
        super().__init__()
        strides = _pair(strides)
        self.layers = nn.ModuleDict({
            "0": Conv(in_features, out_features, kernel_size, ndim=2,
                      stride=strides, bias=False),
            "1": BatchNorm(out_features),
            "3": Conv(out_features, out_features, kernel_size, ndim=2,
                      bias=False),
            "4": BatchNorm(out_features)})
        self.residual = _residual(in_features, out_features, strides)
        self.act = get_act(act_fun)
        self.joined_post_act = joined_post_act

    def forward(self, x):
        y = _bn_act(self, self.layers["1"], self.layers["0"](x))
        return _join(self, self.layers["4"], self.layers["3"](y), x)


class ResNetBottleneckBlock(nn.Module):
    """Bottleneck block (resnet.py:79-117): 1x1 to in / bottleneck_ratio
    channels, `kernel_size` with the block's `strides`, 1x1 to
    out_features; each conv followed by BN, the activation `act_fun` after
    the first two and, with `joined_post_act`, after the residual add (else
    before it)."""

    def __init__(self, in_features: int, out_features: int,
                 bottleneck_ratio: int, strides=1, kernel_size=3,
                 act_fun: str = "ReLU", joined_post_act: bool = True):
        super().__init__()
        strides = _pair(strides)
        mid = in_features // bottleneck_ratio
        self.layers = nn.ModuleDict({
            "0": Conv(in_features, mid, 1, ndim=2, bias=False),
            "1": BatchNorm(mid),
            "3": Conv(mid, mid, kernel_size, ndim=2, stride=strides,
                      bias=False),
            "4": BatchNorm(mid),
            "6": Conv(mid, out_features, 1, ndim=2, bias=False),
            "7": BatchNorm(out_features)})
        self.residual = _residual(in_features, out_features, strides)
        self.act = get_act(act_fun)
        self.joined_post_act = joined_post_act

    def forward(self, x):
        y = _bn_act(self, self.layers["1"], self.layers["0"](x))
        y = _bn_act(self, self.layers["4"], self.layers["3"](y))
        return _join(self, self.layers["7"], self.layers["6"](y), x)


class ResNet(nn.Module):
    """ResNet (resnet.py:120-164): the stem (7x7/2 bias-free conv, BN, ReLU,
    3x3/2 max pool with padding 1) when `include_stem`, four stages (the
    first block of stage 0 stride 1 and bottleneck ratio 1, the first block
    of later stages stride 2 and ratio 2, the rest stride 1 and ratio 4),
    then, when `include_head`, a global average pool and a Linear to
    dim_output (he-normal weights and zero bias by default).

    Input (N, 3, H, W) with the stem, else (N, 64, H, W); output (N,
    dim_output) with the head, else the last stage's (N, C, H', W')."""

    def __init__(self, model: str = "ResNet50", dim_output: int = 1000,
                 include_stem: bool = True, include_head: bool = True,
                 in_channels: int = 3, head_weight_init: str = "he_normal",
                 head_bias_init: str = "zeros"):
        super().__init__()
        cfg = _CONFIGS[model]
        self.stem = None
        if include_stem:
            self.stem = nn.ModuleDict({
                "0": Conv(in_channels, cfg["dim_stem"], 7, ndim=2, stride=2,
                          bias=False),
                "1": BatchNorm(cfg["dim_stem"])})
        blocks, prev = [], cfg["dim_stem"]
        for stage, (dim, n) in enumerate(zip(cfg["dim_blocks"],
                                             cfg["num_blocks"])):
            for block_id in range(n):
                if block_id == 0 and stage == 0:
                    stride, ratio = 1, 1
                elif block_id == 0:
                    stride, ratio = 2, 2
                else:
                    stride, ratio = 1, 4
                blocks.append(ResNetBottleneckBlock(prev, dim, ratio, stride)
                              if cfg["bottleneck"]
                              else ResNetBlock(prev, dim, stride))
                prev = dim
        self.blocks = nn.ModuleList(blocks)
        self.head = (nn.ModuleDict({"1": Linear(
            prev, dim_output, weight_init=head_weight_init,
            bias_init=head_bias_init)}) if include_head else None)

    def forward(self, x):
        if self.stem is not None:
            x = self.stem["1"](self.stem["0"](x), relu=True)
            x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")),
                             3, 2)
        for block in self.blocks:
            x = block(x)
        if self.head is None:
            return x
        return self.head["1"](x.mean(dim=(2, 3)))
