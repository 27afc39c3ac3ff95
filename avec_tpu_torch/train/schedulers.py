"""Step schedulers (port of avec_tpu/train/schedulers.py).

A scheduler maps the already incremented step (1 at the first update) to a
value; the optimizer asks for `scheduler(step + 1)` with the step counter
before the update. Steps are Python numbers, and so are the values.
"""

import math


class Scheduler:
    """A function of the step; subclasses define __call__."""

    def __call__(self, step):
        raise NotImplementedError


class ConstantScheduler(Scheduler):
    def __init__(self, val: float):
        self.val = val

    def __call__(self, step) -> float:
        return self.val


class ConstantDecayScheduler(Scheduler):
    """Piecewise constant (schedulers.py:51-74): values[i + 1] once step >
    decay_steps[i] (values has one more entry than decay_steps)."""

    def __init__(self, values, decay_steps):
        self.values = list(values)
        self.decay_steps = list(decay_steps)

    def __call__(self, step) -> float:
        val = self.values[0]
        for i, start in enumerate(self.decay_steps):
            if step > start:
                val = self.values[i + 1]
            else:
                break
        return val


class WarmupConstantDecayScheduler(Scheduler):
    """Linear warmup to values[0] over warmup_steps, then the piecewise
    constant decay (schedulers.py:77-90)."""

    def __init__(self, warmup_steps, values, decay_steps):
        self.warmup_steps = warmup_steps
        self.values = list(values)
        self.decay_steps = list(decay_steps)

    def __call__(self, step) -> float:
        if step <= self.warmup_steps:
            return step / self.warmup_steps * self.values[0]
        return ConstantDecayScheduler(self.values, self.decay_steps)(step)


class LinearDecayScheduler(Scheduler):
    """value_start to value_end linearly over decay_steps, value_end after
    (schedulers.py:93-105)."""

    def __init__(self, value_start, value_end, decay_steps):
        self.value_start = value_start
        self.value_end = value_end
        self.decay_steps = decay_steps

    def __call__(self, step) -> float:
        if step >= self.decay_steps:
            return self.value_end
        return (self.value_start - step * (self.value_start - self.value_end)
                / self.decay_steps)


class NoamDecayScheduler(Scheduler):
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


class ExpDecayScheduler(Scheduler):
    """min(linear warmup to val_max, val_max * alpha^((step - warmup) /
    (end_step - warmup))) (schedulers.py:131-146)."""

    def __init__(self, warmup_steps, val_max, alpha, end_step):
        self.warmup_steps = warmup_steps
        self.val_max = val_max
        self.alpha = alpha
        self.end_step = end_step

    def __call__(self, step) -> float:
        warm = step / self.warmup_steps * self.val_max
        frac = ((step - self.warmup_steps)
                / (self.end_step - self.warmup_steps))
        return min(warm, self.val_max * self.alpha ** frac)


class CosineAnnealingScheduler(Scheduler):
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


scheduler_dict = {
    "Constant": ConstantScheduler,
    "ConstantDecay": ConstantDecayScheduler,
    "WarmupConstantDecay": WarmupConstantDecayScheduler,
    "LinearDecay": LinearDecayScheduler,
    "NoamDecay": NoamDecayScheduler,
    "ExpDecay": ExpDecayScheduler,
    "CosineAnnealing": CosineAnnealingScheduler,
}
