"""Step schedulers (port of avec_tpu/train/schedulers.py:108-128).

A scheduler maps the already incremented step (1 at the first update) to a
value; the optimizer asks for `scheduler(step + 1)` with the step counter
before the update.
"""


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


def as_scheduler(value):
    """A number becomes a constant scheduler; a callable stays."""
    return value if callable(value) else ConstantScheduler(float(value))
