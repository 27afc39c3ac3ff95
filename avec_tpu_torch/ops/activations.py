"""Activation functions (port of avec_tpu/ops/activations.py)."""

import torch


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish / SiLU: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gated linear unit: split in half on `dim`, a * sigmoid(b)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, the exact erf form (activations.py:53-55)."""
    return torch.nn.functional.gelu(x, approximate="none")


act_dict = {"Swish": swish, "ReLU": torch.relu, "GELU": gelu}


def get_act(name):
    return name if callable(name) else act_dict[name]
