#!/usr/bin/env python3
"""Times of the fused convolution module's four bf16 passes (K3-stats,
K3-fwd, K3b-1, K3b-2) and of the stem kernel (K5) of the PyTorch/H100 port,
at the train step's shapes, for comparing two versions within one chip call.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_conv_stem_times.py [--tree DIR] [--label NAME]

For (B, T, d = E, k) = (16, 301, 180, 15), (16, 151, 256, 15) and (16, 76,
360, 15), bf16, dropout 0.1, it times each pass through its C entry
(`chip_smoke.time_conv_passes`: direct calls between CUDA events, the
device time of the call and of each of its stage kernels from
torch.profiler), and sums them per step with the step's call counts
(`STEP_COUNTS`, the counts `chip_smoke.py` phase 14 derives from the module
tree). K5 is timed in bf16 at the serving shape (1608 frames of 44x44x64)
and the training shape (2416 frames), through its wrapper. It prints one
line per shape and one JSON line with everything and the card's name and
power limit.

`--tree DIR` imports `avec_tpu_torch` from DIR instead (for example the
parent commit unpacked there with `git archive`), whose kernels build into
DIR's own `build/`: two versions compare within one chip call by running
this script once per tree, in turns (parent, change, change, parent).
Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import math
import os
import sys

import torch

CONV_SHAPES = ((16, 301, 180, 15), (16, 151, 256, 15), (16, 76, 360, 15))
STEP_COUNTS = {301: 4, 151: 10, 76: 7}     # fused conv calls per train step
STEM_FRAMES = {"serving": 1608, "training": 2416}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="directory holding the avec_tpu_torch to measure")
    ap.add_argument("--label", default=None, help="name printed with the line")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    import avec_tpu_torch
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.ops.stem import bn_relu_pool

    label = args.label or "repo"
    out = {"label": label, "package": os.path.dirname(avec_tpu_torch.__file__),
           "gpu": cs.gpu_line(), "conv": {}, "per_step": {}, "stem": {}}
    per_step = {name: {"ms": 0.0, "device_ms": 0.0} for name in cm.KERNELS}
    for b, t, d, k in CONV_SHAPES:
        x, g, params = cs.conv_inputs(b, t, d, k, torch.bfloat16, seed=t + 2)
        times = cs.time_conv_passes(x, g, params, 0.1, 77)
        row = {}
        for name in cm.KERNELS:
            row[name] = {"ms": times[name],
                         "device_ms": times[name + "_device"],
                         "stages_us": {nm: ms * 1e3 for nm, ms in
                                       times[name + "_kernels"].items()}}
            per_step[name]["ms"] += STEP_COUNTS[t] * times[name]
            per_step[name]["device_ms"] += (STEP_COUNTS[t]
                                            * times[name + "_device"])
            assert math.isfinite(times[name + "_device"])
        out["conv"][f"T{t}_d{d}"] = row
        print(f"{label} T={t} d={d}: " + "; ".join(
            f"{name[11:]} {row[name]['ms']:.4f} ms (device "
            f"{row[name]['device_ms']:.4f}: " + ", ".join(
                f"{nm} {us:.1f} us" for nm, us in
                row[name]["stages_us"].items()) + ")"
            for name in cm.KERNELS), flush=True)
        del x, g, params
    out["per_step"] = per_step
    print(f"{label} per step: " + "; ".join(
        f"{name[11:]} {v['ms']:.4f} ms (device {v['device_ms']:.4f})"
        for name, v in per_step.items()), flush=True)

    gen = torch.Generator().manual_seed(5)
    a = (torch.rand(64, generator=gen) + 0.5).cuda()
    b = (torch.randn(64, generator=gen) * 0.2).cuda()
    for shape, frames in STEM_FRAMES.items():
        y = torch.randn(frames, 44, 44, 64, generator=gen).to("cuda",
                                                              torch.bfloat16)
        nbytes = y.numel() * 2 + (y.numel() // 4) * 2 + 2 * 64 * 4
        bound = cs.bound(nbytes, 3.0 * y.numel(), "bf16")[0]
        ms = cs.cuda_time_ms(lambda: bn_relu_pool(y, a, b))
        dev = cs.device_time_ms(lambda: bn_relu_pool(y, a, b))[0]
        out["stem"][shape] = {"frames": frames, "ms": ms, "device_ms": dev,
                              "bound_ms": bound}
        print(f"{label} bn_relu_pool {shape} N={frames}: {ms:.4f} ms (device "
              f"{dev:.4f}), bound {bound:.5f}: {ms / bound:.2f}x", flush=True)
        del y
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
