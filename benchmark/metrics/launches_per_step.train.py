"""Host-side kernel, memcpy and memset launch calls per optimizer step in
the traced slice (the profiler's CUDA runtime events)."""


def read(ctx):
    tr = ctx.get("trace") or {}
    steps = ctx.get("steps_in_slice")
    if not tr.get("launches") or not steps:
        return None
    return tr["launches"] / steps
