"""Model FLOPs of the batches submitted in the window (padded shapes) over
its time and 989 TFLOP/s, in %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
