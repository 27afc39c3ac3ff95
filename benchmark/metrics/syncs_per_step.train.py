"""CUDA runtime sync calls (stream, device and event syncs, blocking
`cudaMemcpy`) that start inside `avec/train/step` spans, per step."""

from benchmark import spans


def read(ctx):
    return spans.syncs_per_step(ctx)
