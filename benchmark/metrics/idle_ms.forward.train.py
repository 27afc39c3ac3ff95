"""Device-idle milliseconds a step while the host is in `avec/train/forward`
(the innermost `avec/train/` span at the idle gap's midpoint)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "avec/train/forward")
