"""Step schedulers (port of avec_tpu/train/schedulers.py:108-175).

A scheduler maps the already incremented step (1 at the first update) to a
value; the optimizer asks for `scheduler(step + 1)` with the step counter
before the update.
"""

import math


class ConstantScheduler:
    def __init__(self, val: float):
        self.val = val

    def __call__(self, step) -> float:
        return self.val


class NoamDecayScheduler:
    """factor * dim^-0.5 * min(step * warmup^-1.5, step^-0.5). The conformer
    models use warmup_steps=10000, dim_decay=360, val_factor=2."""

    def __init__(self, warmup_steps: int = 10000, dim_decay: int = 360,
                 val_factor: float = 2):
        self.warmup_steps = warmup_steps
        self.dim_decay = dim_decay
        self.val_factor = val_factor

    def __call__(self, step) -> float:
        scale = self.val_factor * self.dim_decay ** -0.5
        s = max(float(step), 1e-9)
        return scale * min(s * self.warmup_steps ** -1.5, s ** -0.5)


class CosineAnnealingScheduler:
    """Linear warmup to val_max over warmup_steps, cosine annealing to
    val_min at end_step, val_min after it (schedulers.py:149-175; the GPT
    configs: warmup 750, end 520000)."""

    def __init__(self, warmup_steps: int, val_max: float, val_min: float,
                 end_step: int):
        self.warmup_steps = warmup_steps
        self.val_max = val_max
        self.val_min = val_min
        self.end_step = end_step

    def __call__(self, step) -> float:
        if step <= self.warmup_steps:
            return step / self.warmup_steps * self.val_max
        if step <= self.end_step:
            frac = ((step - self.warmup_steps)
                    / (self.end_step - self.warmup_steps))
            return ((self.val_max - self.val_min) * 0.5
                    * (1 + math.cos(math.pi * frac)) + self.val_min)
        return self.val_min


def as_scheduler(value):
    """A number becomes a constant scheduler; a callable stays."""
    return value if callable(value) else ConstantScheduler(float(value))
