"""Rematerialized training of a module (the JAX `nn.remat` of the uniform
conformer block runs, conformer.py:509-513 and :594-611).

`remat_call(module, *args, **kwargs)` runs module(*args, **kwargs) under
`torch.utils.checkpoint` (non-reentrant): the forward keeps none of the
module's activations, and the backward recomputes them from its inputs
before it goes through the module. A rematerialized step is the same step
as the plain one:

* the noise replays. The port's modules draw from explicit generators that
  `checkpoint`'s `preserve_rng_state` does not see: the Dropout masks and
  SpecAugment's time masks from `generator`, the fused kernels' integer
  seeds from `seed_generator` (a CPU generator), SpecAugment's bands from
  `band_generator`. The forward records every such generator's state on
  entry; the recompute sets them back to it, so it draws the forward's
  masks and seeds, and afterwards returns each generator to where the
  backward found it, so no later draw moves;
* no BatchNorm moves its running statistics again: the recompute runs
  inside `running_statistics_held` (the statistics themselves are
  recomputed, and in data-parallel training all-reduced again, in the same
  order on every rank);
* the recompute runs under the forward's autocast state (`checkpoint`
  records it), and the fused autograd Functions keep only what the replay
  gives them again (the seed, the lengths, the process group).

Each rematerialized module launches its fused forward kernels twice per
step (the forward and the recompute); its backward launches are those of
the plain step.
"""

import contextlib
from typing import List

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from avec_tpu_torch.ops.layers import running_statistics_held

_GENERATOR_ATTRS = ("generator", "seed_generator", "band_generator")


def _generators(module: nn.Module) -> List[torch.Generator]:
    """The distinct explicit generators that `module`'s layers draw from."""
    found = {}
    for m in module.modules():
        for attr in _GENERATOR_ATTRS:
            g = getattr(m, attr, None)
            if isinstance(g, torch.Generator):
                found[id(g)] = g
    return list(found.values())


class _Replay:
    """`checkpoint`'s context_fn: (the forward's context, which records the
    generators' states on entry; the recompute's, which replays them)."""

    def __init__(self, generators: List[torch.Generator]):
        self.generators = generators
        self.entry = None

    @contextlib.contextmanager
    def _forward(self):
        self.entry = [g.get_state() for g in self.generators]
        yield

    @contextlib.contextmanager
    def _recompute(self):
        found = [g.get_state() for g in self.generators]
        for g, state in zip(self.generators, self.entry):
            g.set_state(state)
        try:
            with running_statistics_held():
                yield
        finally:
            for g, state in zip(self.generators, found):
                g.set_state(state)

    def __call__(self):
        return self._forward(), self._recompute()


def remat_call(module: nn.Module, *args, **kwargs):
    """module(*args, **kwargs) with its activations recomputed in the
    backward (see the module docstring)."""
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=_Replay(_generators(module)), **kwargs)
