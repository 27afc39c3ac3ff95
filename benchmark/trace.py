"""A traced slice: torch.profiler (CPU and CUDA activities) around a few
seconds of the cell's own work, reduced in memory to what the per-layer
readers and the result's `breakdown` need. No trace file is written.

- busy_s: the union of the device's kernel, copy and set intervals;
- window_s: the slice's host time, from its first call to its last sync;
- device_ops: device seconds by operation name, most first;
- idle_gaps: the gaps between device intervals, each named by the
  innermost host operation running at its midpoint;
- launches: the host's kernel, memcpy and memset launch calls;
- kernel_s: device seconds of the program's hand-written kernels (names of
  the `__global__` functions of `avec_tpu_torch/csrc`).
"""

import bisect
import glob
import os
import re
import time
import warnings
from typing import Callable, Dict, List

import torch

_LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchKernelExC|"
                     r"cudaMemcpyAsync|cudaMemsetAsync|cudaMemcpy|cudaMemset|"
                     r"cuLaunchKernelEx|cudaLaunchCooperativeKernel)")
_SCAN = 400                      # host events searched back for a gap
_NAME = 160                      # characters of a name kept
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(", re.S)


def program_kernels(root: str) -> set:
    """Names of the hand-written kernels in the program's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(root, "avec_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def short_name(name: str) -> str:
    """`void ns::(anonymous namespace)::k<3>(...)` -> `k<3>`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            cut = i
            break
    name, depth, start = name[:cut], 0, 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:].strip()


def _base(name: str) -> str:
    return short_name(name).split("<")[0]


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(fn: Callable[[], None], root: str) -> Dict:
    """Run `fn` once under the profiler (it ends with a device sync) and
    reduce the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = prof.events()
    mine = program_kernels(root)
    dev, host, launches = [], [], 0
    by_op: Dict[str, float] = {}
    kernel_s: Dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            s, t = e.time_range.start, e.time_range.end
            if t <= s:
                continue
            dev.append((s, t))
            name = short_name(e.name)[:_NAME]
            by_op[name] = by_op.get(name, 0.0) + (t - s) / 1e6
            if (_base(e.name) in mine and "at::" not in e.name
                    and "cutlass" not in e.name):
                kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) / 1e6
        else:
            if _LAUNCH.match(e.name):
                launches += 1
            host.append((e.time_range.start, e.time_range.end, e.name))
    merged = _merge(dev)
    busy_s = sum(e - s for s, e in merged) / 1e6
    host.sort()
    starts = [h[0] for h in host]
    gaps = [(s1 - e0, (e0 + s1) / 2) for (_, e0), (s1, _)
            in zip(merged, merged[1:])]
    labelled = []
    for g, mid in gaps:
        i = bisect.bisect_right(starts, mid) - 1
        label = "host idle"
        for j in range(i, max(i - _SCAN, -1), -1):
            h = host[j]
            if h[1] >= mid and not h[2].startswith("ProfilerStep"):
                label = h[2]
                break
        labelled.append((label[:_NAME], g / 1e6))
    gaps = labelled
    gap_by: Dict[str, float] = {}
    for label, g in gaps:
        gap_by[label] = gap_by.get(label, 0.0) + g
    return {
        "busy_s": busy_s, "window_s": window_s, "launches": launches,
        "kernel_s": kernel_s,
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gap_by.items()),
                            key=lambda kv: -kv[1])[:10],
    }
