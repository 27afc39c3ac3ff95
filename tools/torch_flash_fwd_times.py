#!/usr/bin/env python3
"""Times of the flash attention forward (K4) of the PyTorch/H100 port at the
serving path's and the flash training route's shapes, bf16, for comparing
two versions within one chip call.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_flash_fwd_times.py [--tree DIR] [--label NAME]

Serving: (B, H, T, D) = (8, 4, 201, 256) for 6 launches and (8, 4, 101,
360) for 1 per forward, with the audio stage lengths of `chip_smoke.py`'s
served batch; training: B = 16 at T = 151 (6 launches a step) and 76 (1),
with the lengths of its train batch. q' and k' come from
`rel_pos_augment` (d_a = 321 / 451, d_v = 64 / 90). Each shape is timed
through the wrapper (`chip_smoke.cuda_time_ms`: direct calls between CUDA
events) and on the device, whole and by kernel (`chip_smoke.device_time_ms`,
torch.profiler), and summed per forward and per step. It prints one line
per shape and one JSON line with everything and the card's name and power
limit.

`--tree DIR` imports `avec_tpu_torch` (and `chip_smoke`) from DIR instead
(for example the parent commit unpacked there with `git archive`), whose
kernels build into DIR's own `build/`: two versions compare within one chip
call by running this script once per tree, in turns (parent, change,
change, parent). Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

# (B, T, d_model, launches): per served forward, per flash-route train step
SHAPES = {"serving": ((8, 201, 256, 6), (8, 101, 360, 1)),
          "training": ((16, 151, 256, 6), (16, 76, 360, 1))}


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
    from avec_tpu_torch.ops.flash_attention import flash_attention_fwd

    rng = np.random.RandomState(0)
    served = np.array([len(r["audio"]) for r in cs.make_requests(rng)])
    trained = np.asarray(cs.make_train_batch(np.random.RandomState(0))
                         ["inputs"][3])
    lengths = {"serving": cs.stage_lengths(served),
               "training": cs.stage_lengths(trained)}
    label = args.label or "repo"
    out = {"label": label, "package": os.path.dirname(avec_tpu_torch.__file__),
           "gpu": cs.gpu_line(), "shapes": {}, "sums": {}}
    for path, shapes in SHAPES.items():
        total = {"ms": 0.0, "device_ms": 0.0}
        for (b, t, d_model, count), lens in zip(shapes, lengths[path]):
            q, k, v, lt, scale = cs.flash_inputs(b, t, d_model, lens,
                                                 torch.bfloat16, seed=7)

            def call():
                flash_attention_fwd(q, k, v, lt, scale)

            ms = cs.cuda_time_ms(call)
            dev, kernels = cs.device_time_ms(call)
            row = {"count": count, "ms": ms, "device_ms": dev,
                   "kernels_us": {nm: v_ms * 1e3 for nm, v_ms in
                                  kernels.items()},
                   "lengths": [int(x) for x in lens]}
            out["shapes"][f"{path}_T{t}"] = row
            total["ms"] += count * ms
            total["device_ms"] += count * dev
            print(f"{label} {path} B={b} T={t} D={d_model}: {ms:.4f} ms "
                  f"(device {dev:.4f}: " + ", ".join(
                      f"{nm} {us:.1f} us" for nm, us in
                      row["kernels_us"].items()) + ")", flush=True)
            del q, k, v
        out["sums"][path] = total
        print(f"{label} {path} per {'forward' if path == 'serving' else 'step'}"
              f": {total['ms']:.4f} ms (device {total['device_ms']:.4f})",
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
