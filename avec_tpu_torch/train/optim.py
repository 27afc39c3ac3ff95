"""Optimizer of the conformer models (port of avec_tpu/train/optim.py:34-84
and avec_tpu/models/zoo.py:35-38).

`torch.optim.Adam` has the JAX package's semantics: the L2 weight decay is
added to the gradient before the moments, and eps is added to the root of
the bias-corrected second moment. Its learning rate is set from the
scheduler at every step: lr = scheduler(step + 1), `step` being the counter
before the update.

`Adam(lr=..., betas=..., eps=..., weight_decay=...)` takes the JAX
package's arguments, `lr` a number or a step scheduler, and returns a
function of the parameters that makes the `Optimizer`: the form the
`Trainer`'s `optimizer` argument takes (a config builds the optimizer
before the model has parameters).
"""

from typing import Callable, Iterable, Tuple

import torch

from avec_tpu_torch.train.schedulers import NoamDecayScheduler, as_scheduler


class Optimizer:
    """A torch optimizer driven by a step scheduler."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler):
        self.optimizer = optimizer
        self.scheduler = as_scheduler(scheduler)

    def learning_rate(self, step: int) -> float:
        return self.scheduler(step + 1)

    def update(self, step: int) -> float:
        """Apply the parameters' `.grad` at the pre-increment `step`;
        returns the learning rate used."""
        lr = self.learning_rate(step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return lr


def Adam(lr=0.001, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0
         ) -> Callable[[Iterable[torch.nn.Parameter]], Optimizer]:
    """Adam with L2 in the gradient under `lr` (a number or a scheduler of
    the incremented step); returns `make(params) -> Optimizer`."""
    scheduler = as_scheduler(lr)

    def make(params) -> Optimizer:
        adam = torch.optim.Adam(params, lr=scheduler(1), betas=betas,
                                eps=eps, weight_decay=weight_decay)
        return Optimizer(adam, scheduler)

    return make


def noam_adam(params) -> Optimizer:
    """Adam betas (0.9, 0.98), eps 1e-9, weight decay 1e-6 under the Noam
    schedule (warmup 10000, dim 360, factor 2): the conformer models'
    default."""
    return Adam(lr=NoamDecayScheduler(warmup_steps=10000, dim_decay=360,
                                      val_factor=2),
                betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6)(params)
