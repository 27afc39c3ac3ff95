"""Median host milliseconds of one Server.submit_batch call in the window."""

from benchmark import readers


def read(ctx):
    return readers.median_of(ctx, "submit_ms")
