"""Model FLOPs of the training window (3 forwards a step on the padded
shapes) over its time and 989 TFLOP/s, in %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
