"""Weight initializer registry (port of avec_tpu/ops/inits.py).

An initializer fills a tensor in place from an explicit `torch.Generator`:
`init(tensor, generator, fans=None)`. The distributions are the JAX
package's:

  uniform         U(-1, 1)            normal          N(0, 1)
  scaled_uniform  U(-b, b), b = sqrt(1 / fan_in)
  scaled_normal   N(0, 1 / fan_in)
  lecun_uniform   U(-b, b), b = sqrt(3 / fan_in)
  lecun_normal    N(0, 1 / fan_in)
  he_uniform      U(-b, b), b = sqrt(6 / fan_in)
  he_normal       N(0, 2 / fan_in)
  xavier_uniform  U(-b, b), b = sqrt(6 / (fan_in + fan_out))
  xavier_normal   N(0, 2 / (fan_in + fan_out))
  normal_02       N(0, 0.02^2)
  default         U(-1 / sqrt(fan_in), 1 / sqrt(fan_in)) (torch's Linear
                  and Conv default)
  ones, zeros

Fans are computed on the port's weight layout (out, in, *kernel), so they
equal the JAX fans of the same weight in its (*kernel, in, out) layout:
fan_in = in * prod(kernel), fan_out = out * prod(kernel); a 1-d tensor has
fan_in = fan_out = its size. A layer whose weight has another layout
(ConvTranspose's (in, out, *kernel), Embedding's (num, features)) passes
its `fans`.
"""

import math
from typing import Callable, Optional, Tuple

import torch


def compute_fans(shape) -> Tuple[int, int]:
    """(fan_in, fan_out) of a weight of the (out, in, *kernel) layout."""
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _uniform_bound(bound_fn) -> Callable:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None,
             fans=None):
        fan_in, fan_out = fans or compute_fans(t.shape)
        b = bound_fn(fan_in, fan_out)
        with torch.no_grad():
            return t.uniform_(-b, b, generator=generator)
    return init


def _normal_std(std_fn) -> Callable:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None,
             fans=None):
        fan_in, fan_out = fans or compute_fans(t.shape)
        with torch.no_grad():
            return t.normal_(0.0, std_fn(fan_in, fan_out), generator=generator)
    return init


def constant_init(value: float) -> Callable:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None,
             fans=None):
        with torch.no_grad():
            return t.fill_(value)
    return init


zeros_init = constant_init(0.0)
ones_init = constant_init(1.0)
torch_default = _uniform_bound(lambda fi, fo: 1.0 / math.sqrt(fi))


def torch_default_bias(fan_in: int) -> Callable:
    """torch's default bias: U(-1 / sqrt(fan_in), 1 / sqrt(fan_in)) of the
    layer's weight fan_in (0 when fan_in is 0)."""
    b = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform_bound(lambda fi, fo: b)


init_dict = {
    "uniform": _uniform_bound(lambda fi, fo: 1.0),
    "normal": _normal_std(lambda fi, fo: 1.0),
    "ones": ones_init,
    "zeros": zeros_init,
    "scaled_uniform": _uniform_bound(lambda fi, fo: math.sqrt(1.0 / fi)),
    "scaled_normal": _normal_std(lambda fi, fo: math.sqrt(1.0 / fi)),
    "lecun_uniform": _uniform_bound(lambda fi, fo: math.sqrt(3.0 / fi)),
    "lecun_normal": _normal_std(lambda fi, fo: math.sqrt(1.0 / fi)),
    "he_uniform": _uniform_bound(lambda fi, fo: math.sqrt(6.0 / fi)),
    "he_normal": _normal_std(lambda fi, fo: math.sqrt(2.0 / fi)),
    "xavier_uniform": _uniform_bound(
        lambda fi, fo: math.sqrt(6.0 / (fi + fo))),
    "xavier_normal": _normal_std(lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
    "normal_02": _normal_std(lambda fi, fo: 0.02),
    "default": torch_default,
}


def get_init(name_or_fn, default: str = "default") -> Callable:
    """A registry name (None: `default`) or an initializer -> the
    initializer."""
    if name_or_fn is None:
        name_or_fn = default
    if callable(name_or_fn):
        return name_or_fn
    return init_dict[name_or_fn]
