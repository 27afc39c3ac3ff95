"""Variational ("synaptic") weight noise (port of
avec_tpu/ops/variational_noise.py).

Functional, as the JAX package's: `sample_synaptic_noise` returns a new
{name: tensor} of the parameters with N(0, std^2) noise added to the masked
ones, drawn from an explicit `torch.Generator`, for a forward through
`torch.func.functional_call`. `init_vn` only records `vn_std` on a trainer
or model; no train step reads it, in either package.
"""

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

ParamsLike = Union[nn.Module, Dict[str, torch.Tensor]]


def _named(params: ParamsLike) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def make_vn_mask(params: ParamsLike,
                 predicate: Optional[Callable] = None) -> Dict[str, bool]:
    """{name: whether it takes noise} (variational_noise.py:28-41). Default:
    the weight matrices and kernels (a last name part starting with
    "weight" and at least 2 dimensions: Linear, Conv, ConvTranspose, LSTM
    and Embedding weights, the JAX `kernel` / `embedding` leaves), not the
    1-d norm scales or biases. `predicate(name, tensor)` replaces the
    rule."""
    def decide(name, t):
        if predicate is not None:
            return bool(predicate(name, t))
        return name.rsplit(".", 1)[-1].startswith("weight") and t.ndim >= 2

    return {n: decide(n, t) for n, t in _named(params).items()}


def sample_synaptic_noise(params: ParamsLike, generator: torch.Generator,
                          std: float, mask: Optional[Dict[str, bool]] = None
                          ) -> Dict[str, torch.Tensor]:
    """{name: tensor + std * N(0, 1)} for the masked names, the others
    unchanged (variational_noise.py:44-61); std 0 returns them as they are.
    The draws come from `generator` (on the parameters' device), one
    tensor after another in name order."""
    named = _named(params)
    if std == 0.0:
        return named
    if mask is None:
        mask = make_vn_mask(named)
    out = {}
    for name, t in named.items():
        if mask.get(name, False):
            noise = torch.randn(t.shape, generator=generator, device=t.device,
                                dtype=t.dtype)
            out[name] = t + std * noise
        else:
            out[name] = t
    return out


def init_vn(model, vn_std: float):
    """Set `vn_std` on a trainer or model (variational_noise.py:64-67)."""
    model.vn_std = vn_std
    return model
