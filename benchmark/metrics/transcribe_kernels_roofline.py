"""The program's hand-written kernel calls in the traced slice: the sum of
their bounds over the sum of their device times, in %."""

from benchmark import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
