"""ResNet trunk (port of avec_tpu/models/resnet.py), NCHW; its BatchNorms
use batch statistics in training mode, those of the global batch in
data-parallel training.

AVEC uses ResNet18 without its stem as the per-frame visual trunk
(include_stem=False, dim_output=256). Convs are bias-free with "same"
padding; the post-activation follows the residual add. Names follow the
reference: blocks.{i}.layers.{0 conv1, 1 bn1, 3 conv2, 4 bn2},
blocks.{i}.residual.{0 conv, 1 bn}, head.1.
"""

import torch
import torch.nn as nn

from avec_tpu_torch.ops.layers import BatchNorm, Conv, Linear

_CONFIGS = {"ResNet18": dict(dim_stem=64, dim_blocks=(64, 128, 256, 512),
                             num_blocks=(2, 2, 2, 2))}


class ResNetBlock(nn.Module):
    """Basic residual block (resnet.py:43)."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1):
        super().__init__()
        self.layers = nn.ModuleDict({
            "0": Conv(in_features, out_features, 3, ndim=2, stride=stride,
                      bias=False),
            "1": BatchNorm(out_features),
            "3": Conv(out_features, out_features, 3, ndim=2, bias=False),
            "4": BatchNorm(out_features)})
        self.residual = None
        if stride != 1 or in_features != out_features:
            self.residual = nn.ModuleDict({
                "0": Conv(in_features, out_features, 1, ndim=2, stride=stride,
                          bias=False),
                "1": BatchNorm(out_features)})

    def forward(self, x):
        y = torch.relu(self.layers["1"](self.layers["0"](x)))
        y = self.layers["4"](self.layers["3"](y))
        res = x if self.residual is None else \
            self.residual["1"](self.residual["0"](x))
        return torch.relu(y + res)


class ResNet(nn.Module):
    """ResNet18 trunk without stem (resnet.py:120): stage-entry blocks stride
    2 after the first stage, then global average pool and a Linear head."""

    def __init__(self, model: str = "ResNet18", dim_output: int = 256):
        super().__init__()
        cfg = _CONFIGS[model]
        blocks, prev = [], cfg["dim_stem"]
        for stage, (dim, n) in enumerate(zip(cfg["dim_blocks"],
                                             cfg["num_blocks"])):
            for block_id in range(n):
                stride = 2 if (block_id == 0 and stage > 0) else 1
                blocks.append(ResNetBlock(prev, dim, stride))
                prev = dim
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.ModuleDict({"1": Linear(prev, dim_output)})

    def forward(self, x):
        """x: (N, C, H, W) -> (N, dim_output)."""
        for block in self.blocks:
            x = block(x)
        return self.head["1"](x.mean(dim=(2, 3)))
