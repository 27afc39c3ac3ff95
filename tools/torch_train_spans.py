#!/usr/bin/env python3
"""One traced run of a training cell of the benchmark, with its traced slice
reduced twice: by `benchmark/trace.py` (the result's line, as
`benchmark/run.py --trace 1` prints it) and by `benchmark/spans.py` (device
idle by the innermost phase span, syncs, device seconds a span launched),
beside the slice's device seconds by operation name (the 30 costliest) and
those of the training BatchNorm kernels (`bn_` names).

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_train_spans.py --workload av_train --seed N \\
        [--seconds 30] [--tree DIR] [--label NAME]

`--tree DIR` runs the benchmark and the program of DIR instead (for
example the parent commit unpacked there with `git archive`): a tree
without spans in its program reads no span. It prints the run's line and
then one JSON line with the reductions. Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="av_train")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.tree or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)

    import torch.profiler as tp
    from torch.autograd import DeviceType
    from benchmark import run as brun, spans, trace

    captured = []

    class Capture(tp.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            captured.append(self)
            return out

    tp.profile = Capture
    brun._caches()
    result = brun.run(args.workload, args.seed, args.seconds, True)
    events = captured[-1].events()
    by_name = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        t = (e.time_range.end - e.time_range.start) / 1e6
        name = trace.short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    reduced = spans.reduce(spans.plain(events, trace.program_kernels(root)))
    line = {k: result[k] for k in ("metrics", "breakdown", "trace",
                                   "correct", "compared") if k in result}
    print(json.dumps(line), flush=True)
    print(json.dumps({
        "label": args.label or root, "seed": args.seed,
        "spans": reduced, "device_ops_top30": top[:30],
        "bn_kernels_s": {k: v for k, v in by_name.items()
                         if k.startswith("bn_")},
        "device_ops_s": sum(by_name.values())}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
