"""The recorded hand-written kernel calls' bound seconds over the device
seconds of every operation launched inside an `avec/kernel/` span, in %."""

from benchmark import spans


def read(ctx):
    return spans.kernel_spans_roofline(ctx)
