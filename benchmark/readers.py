"""Arithmetic the per-layer readers share. Each returns None where the run
gave nothing to read, never 0 for a share of a peak or a roofline."""

import statistics

from benchmark import costs


def mfu(ctx, busy_key: str = "window_s"):
    """Model FLOPs of the window over its time and the bf16 peak, in %."""
    w = ctx.get("window") or {}
    t = w.get(busy_key)
    if not w.get("flops") or not t:
        return None
    return 100.0 * w["flops"] / t / costs.PEAK_OPS["bf16"]


def kernel_roofline(ctx):
    """The hand-written kernels' bound seconds over their device seconds
    in the traced slice, in %."""
    spent = sum((ctx.get("trace") or {}).get("kernel_s", {}).values())
    bound = ctx.get("kernel_bound_s") or 0.0
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def idle_share(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("window_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def median_of(ctx, key: str):
    values = (ctx.get("window") or {}).get(key) or []
    return float(statistics.median(values)) if values else None


def mean_of(ctx, key: str):
    values = (ctx.get("window") or {}).get(key) or []
    return float(sum(values)) / len(values) if values else None
