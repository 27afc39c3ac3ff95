"""The program's own spans in a traced slice: the `avec/` events of
`avec_tpu_torch/utils/spans.py`, which the profiler records beside the CUDA
runtime calls and the device's operations on one clock.

`plain(events, mine)` keeps what `reduce` needs of the profiler's events, as
tuples (times in microseconds):

- ("span", name, start, end): an `avec/` span on the host;
- ("call", name, start, end, corr): a CUDA runtime call, with the
  correlation id that ties a launch to the operation it launched;
- ("op", name, start, end, corr, mine): an operation on the device; `mine`
  where it is a `__global__` function of the program's CUDA sources.

`reduce(records)` gives, for each span name, over the slice:

- count: spans of the name;
- host_s: their host seconds;
- device_s: device seconds of the operations whose launching call started
  inside a span of the name;
- idle_s: device-idle seconds whose gap's midpoint lies in a span of the
  name, where the name is the innermost `avec/train/` span at that point;
- syncs: runtime sync calls (`SYNCS`) that started inside a span of the
  name;

and besides: the steps (spans `avec/train/step`), the slice's idle seconds
(before the first operation, between operations and after the last: from
the first step's start to the end of the last step or operation, which is
the traced window up to microseconds; without a step, from the first record
to the last) and the part of it in no `avec/train/` span, the
device seconds launched inside any `avec/kernel/` span, and the device
seconds of the program's kernels launched outside one (`unmatched_kernel_s`)
or with no correlated call (`uncorrelated_s`).
"""

import bisect
from typing import Dict, List, Optional

TRAIN = "avec/train/"
KERNEL = "avec/kernel/"
STEP = "avec/train/step"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def plain(events, mine: set) -> List[tuple]:
    """The records of `reduce` from the profiler's FunctionEvents; `mine`
    holds the names of the program's `__global__` functions."""
    from torch.autograd import DeviceType

    from benchmark.trace import _base

    records, ops = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or t <= s:
                continue
            ops.append(("op", e.name, s, t, e.id,
                        _base(e.name) in mine and "at::" not in e.name
                        and "cutlass" not in e.name))
        elif e.name.startswith("avec/"):
            records.append(("span", e.name, s, t))
        elif e.name.startswith("cu"):
            records.append(("call", e.name, s, t, e.id))
    return records + ops


class _Points:
    """Sorted points with weights: the weight that falls in a union of
    intervals."""

    def __init__(self, pairs):
        pairs = sorted(pairs)
        self.x = [p for p, _ in pairs]
        self.cum = [0.0]
        for _, w in pairs:
            self.cum.append(self.cum[-1] + w)

    def within(self, union: List[list]) -> float:
        total = 0.0
        for s, e in union:
            i = bisect.bisect_left(self.x, s)
            j = bisect.bisect_right(self.x, e)
            total += self.cum[j] - self.cum[i]
        return total


def reduce(records: List[tuple]) -> Dict:
    from benchmark.trace import _merge

    spans = [r for r in records if r[0] == "span"]
    calls = [r for r in records if r[0] == "call"]
    ops = [r for r in records if r[0] == "op"]
    steps = [r for r in spans if r[1] == STEP]
    if steps:
        first = min(r[2] for r in steps)
        last = max(r[3] for r in steps + ops)
    else:
        first = min((r[2] for r in records), default=0.0)
        last = max((r[3] for r in records), default=0.0)
    busy = _merge((r[2], r[3]) for r in ops)
    edges = [first] + [x for iv in busy for x in iv] + [last]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle_s = sum(b - a for a, b in gaps) / 1e6

    # the device seconds of each op at the start of its launching call
    start_of = {r[4]: r[2] for r in calls}
    launched, mine_launched, mine_s, uncorrelated = [], [], 0.0, 0.0
    for _, _, s, t, corr, is_mine in ops:
        secs = (t - s) / 1e6
        mine_s += secs if is_mine else 0.0
        if corr not in start_of:
            uncorrelated += secs
            continue
        launched.append((start_of[corr], secs))
        if is_mine:
            mine_launched.append((start_of[corr], secs))
    device = _Points(launched)
    syncs = _Points((r[2], 1.0) for r in calls if r[1] in SYNCS)

    # the innermost avec/train/ span at each gap's midpoint: outer spans
    # first, inner ones overwrite
    mids = sorted(((a + b) / 2, (b - a) / 1e6) for a, b in gaps)
    xs = [m for m, _ in mids]
    label: List[Optional[str]] = [None] * len(mids)
    train = sorted((r for r in spans if r[1].startswith(TRAIN)),
                   key=lambda r: (r[2], -r[3]))
    for _, name, s, t in train:
        i, j = bisect.bisect_left(xs, s), bisect.bisect_right(xs, t)
        label[i:j] = [name] * (j - i)
    idle_by: Dict[str, float] = {}
    for name, (_, g) in zip(label, mids):
        idle_by[name] = idle_by.get(name, 0.0) + g

    by_name: Dict[str, list] = {}
    for _, name, s, t in spans:
        by_name.setdefault(name, []).append((s, t))
    out = {}
    for name, iv in sorted(by_name.items()):
        union = _merge(iv)
        out[name] = {"count": len(iv),
                     "host_s": sum(t - s for s, t in iv) / 1e6,
                     "device_s": device.within(union),
                     "idle_s": idle_by.get(name, 0.0),
                     "syncs": int(round(syncs.within(union)))}
    kernel_union = _merge((s, t) for _, name, s, t in spans
                          if name.startswith(KERNEL))
    return {"steps": len(steps), "by_span": out,
            "idle_s": idle_s, "unattributed_idle_s": idle_by.get(None, 0.0),
            "kernel_device_s": device.within(kernel_union),
            "unmatched_kernel_s": (
                mine_s - _Points(mine_launched).within(kernel_union)),
            "uncorrelated_s": uncorrelated}


# ------------------------------------------------------- reader arithmetic
def _summary(ctx) -> Optional[Dict]:
    sp = (ctx.get("trace") or {}).get("spans")
    return sp if sp and sp.get("steps") else None


def idle_ms_per_step(ctx, *names: str) -> Optional[float]:
    """Device-idle milliseconds a step in the innermost spans `names`."""
    sp = _summary(ctx)
    if sp is None or not any(n in sp["by_span"] for n in names):
        return None
    idle = sum(sp["by_span"][n]["idle_s"] for n in names
               if n in sp["by_span"])
    return 1e3 * idle / sp["steps"]


def syncs_per_step(ctx) -> Optional[float]:
    sp = _summary(ctx)
    return None if sp is None else sp["by_span"][STEP]["syncs"] / sp["steps"]


def kernel_spans_roofline(ctx) -> Optional[float]:
    """The recorded kernel calls' bound seconds over the device seconds
    launched inside `avec/kernel/` spans, in %."""
    sp = _summary(ctx)
    bound = ctx.get("kernel_bound_s") or 0.0
    if sp is None or sp["kernel_device_s"] <= 0 or bound <= 0:
        return None
    return 100.0 * bound / sp["kernel_device_s"]
