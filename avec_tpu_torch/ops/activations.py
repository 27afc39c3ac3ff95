"""Activation functions (port of avec_tpu/ops/activations.py): Swish, GLU,
TanhGLU, the exact GELU and the registry of the reference's names."""

import functools

import torch
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish / SiLU: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gated linear unit: split in half on `dim`, a * sigmoid(b)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def tanh_glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Tanh-gated linear unit: split in half on `dim`, tanh(a) * sigmoid(b)
    (activations.py:47-51)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return torch.tanh(a) * torch.sigmoid(b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, the exact erf form (activations.py:53-55)."""
    return F.gelu(x, approximate="none")


act_dict = {
    "Identity": identity,
    "ReLU": torch.relu,
    "ReLU6": lambda x: torch.clamp(torch.relu(x), max=6.0),
    "LeakyReLU": F.leaky_relu,          # slope 0.01, as jax.nn.leaky_relu
    "GELU": gelu,
    "Swish": swish,
    "SiLU": swish,
    "Sigmoid": torch.sigmoid,
    "Softmax": lambda x: torch.softmax(x, dim=-1),
    "Tanh": torch.tanh,
    "GLU": glu,
    "TanhGLU": tanh_glu,
}


def get_act(act_fun):
    """A name, a {"class": name, "params": {...}} spec or a callable ->
    the activation (activations.py:74-86); a spec's `axis` is `dim` here."""
    if callable(act_fun):
        return act_fun
    if isinstance(act_fun, dict):
        fn = act_dict[act_fun["class"]]
        params = dict(act_fun.get("params", {}))
        if "axis" in params:
            params["dim"] = params.pop("axis")
        return functools.partial(fn, **params) if params else fn
    return act_dict[act_fun]
