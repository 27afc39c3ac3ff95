"""Mean requests in a batch the batcher submitted in the window."""

from benchmark import readers


def read(ctx):
    return readers.mean_of(ctx, "batch_rows")
