"""Optimizers of the conformer and GPT models (port of avec_tpu/train/
optim.py:34-116 and avec_tpu/models/zoo.py:35-38).

`torch.optim.Adam` has the JAX package's semantics: the L2 weight decay is
added to the gradient before the moments, and eps is added to the root of
the bias-corrected second moment. `torch.optim.AdamW` has those of the JAX
AdamW (optax's Adam scale, then the decoupled decay wd * p added to the
update, both scaled by lr). The learning rate is set from the scheduler at
every step: lr = scheduler(step + 1), `step` being the counter before the
update.

`SGD` and `RMSprop` follow the JAX package's optax chains (optim.py:64-127),
not `torch.optim`'s own RMSprop: the L2 weight decay is added to the
gradient first; SGD's momentum is `optax.trace` (no dampening, which the JAX
SGD ignores too, and optax's Nesterov form g + m * trace, which
`torch.optim.SGD` with dampening 0 computes); RMSprop is `scale_by_rms`,
g / sqrt(nu + eps) with nu = alpha nu + (1 - alpha) g^2 from nu = 0, then
`optax.trace` when momentum is set.

`Adam(...)`, `AdamW(...)`, `SGD(...)` and `RMSprop(...)` take the JAX
package's arguments, `lr` a number or a step scheduler, and return a
function of the model (or of its parameters) that makes the `Optimizer`:
the form the `Trainer`'s `optimizer` argument takes (a config builds the
optimizer before the model has parameters). `optim_dict` maps their names.
"""

from typing import Callable, Dict, Iterable, Tuple, Union

import torch
import torch.nn as nn

from avec_tpu_torch.train.schedulers import NoamDecayScheduler, as_scheduler

ParamsLike = Union[nn.Module, Iterable[nn.Parameter]]


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


def _params(model: ParamsLike):
    return model.parameters() if isinstance(model, nn.Module) else model


def Adam(lr=0.001, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0
         ) -> Callable[[ParamsLike], Optimizer]:
    """Adam with L2 in the gradient under `lr` (a number or a scheduler of
    the incremented step); returns `make(model or params) -> Optimizer`."""
    scheduler = as_scheduler(lr)

    def make(model) -> Optimizer:
        adam = torch.optim.Adam(_params(model), lr=scheduler(1), betas=betas,
                                eps=eps, weight_decay=weight_decay)
        return Optimizer(adam, scheduler)

    return make


def gpt_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """The GPT's decay / no-decay split (optim.py:98-116) by parameter
    name: the weights of Linear and Conv layers decay; embeddings, position
    tables, norm affines (a LayerNorm's scale is also `weight`) and biases
    do not."""
    from avec_tpu_torch.ops.layers import Conv, Linear

    decayed = {id(m.weight) for m in model.modules()
               if isinstance(m, (Linear, Conv))}
    return {name: id(p) in decayed for name, p in model.named_parameters()}


def AdamW(lr=0.001, betas: Tuple[float, float] = (0.9, 0.999),
          eps: float = 1e-8, weight_decay: float = 0.01,
          decay_mask: Callable[[nn.Module], Dict[str, bool]] = None
          ) -> Callable[[ParamsLike], Optimizer]:
    """Adam with decoupled weight decay (optim.py:86-95) under `lr`; with
    `decay_mask` (a function of the model, e.g. `gpt_decay_mask`) only the
    parameters it marks decay. Returns `make(model) -> Optimizer`; without
    a mask `make` also takes an iterable of parameters."""
    scheduler = as_scheduler(lr)

    def make(model) -> Optimizer:
        if decay_mask is None:
            groups = [{"params": list(_params(model))}]
        else:
            mask = decay_mask(model)
            named = list(model.named_parameters())
            groups = [{"params": [p for n, p in named if mask[n]]},
                      {"params": [p for n, p in named if not mask[n]],
                       "weight_decay": 0.0}]
        adamw = torch.optim.AdamW(groups, lr=scheduler(1), betas=betas,
                                  eps=eps, weight_decay=weight_decay)
        return Optimizer(adamw, scheduler)

    return make


def SGD(lr, momentum: float = 0.0, dampening: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False
        ) -> Callable[[ParamsLike], Optimizer]:
    """SGD with L2 in the gradient and optax's momentum trace under `lr`
    (optim.py:64-71); `dampening` is accepted and ignored, as the JAX SGD
    ignores it. Returns `make(model or params) -> Optimizer`."""
    scheduler = as_scheduler(lr)

    def make(model) -> Optimizer:
        sgd = torch.optim.SGD(_params(model), lr=scheduler(1),
                              momentum=momentum, dampening=0.0,
                              weight_decay=weight_decay,
                              nesterov=nesterov and bool(momentum))
        return Optimizer(sgd, scheduler)

    return make


class OptaxRMSprop(torch.optim.Optimizer):
    """optax's chain add_decayed_weights(weight_decay), scale_by_rms(alpha,
    eps) (eps inside the square root, nu starting at 0), trace(momentum),
    then p -= lr * update. State per parameter: "nu", and "trace" with
    momentum."""

    def __init__(self, params, lr: float, alpha: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            alpha, m = group["alpha"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if m:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - alpha) * g.square() + alpha * nu)
                u = torch.rsqrt(nu + group["eps"]) * g
                if m:
                    trace = state["trace"]
                    trace.copy_(u + m * trace)
                    u = trace
                p.add_(-group["lr"] * u)


def RMSprop(lr=0.01, alpha: float = 0.99, eps: float = 1e-8,
            weight_decay: float = 0.0, momentum: float = 0.0
            ) -> Callable[[ParamsLike], Optimizer]:
    """RMSprop as the JAX package's optax chain (optim.py:118-126) under
    `lr`; returns `make(model or params) -> Optimizer`."""
    scheduler = as_scheduler(lr)

    def make(model) -> Optimizer:
        return Optimizer(OptaxRMSprop(_params(model), lr=scheduler(1),
                                      alpha=alpha, eps=eps,
                                      weight_decay=weight_decay,
                                      momentum=momentum), scheduler)

    return make


def noam_adam(params) -> Optimizer:
    """Adam betas (0.9, 0.98), eps 1e-9, weight decay 1e-6 under the Noam
    schedule (warmup 10000, dim 360, factor 2): the conformer models'
    default."""
    return Adam(lr=NoamDecayScheduler(warmup_steps=10000, dim_decay=360,
                                      val_factor=2),
                betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6)(params)


optim_dict = {"SGD": SGD, "RMSprop": RMSprop, "Adam": Adam, "AdamW": AdamW}
