"""Model FLOPs of the batches submitted in the window over the union of
their submit-to-finish intervals and 989 TFLOP/s, in %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "busy_s")
