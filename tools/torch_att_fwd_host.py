#!/usr/bin/env python3
"""Where the bf16 fused-attention forward (K2) of the PyTorch/H100 port
spends its time, at the train step's two attention shapes.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_att_fwd_host.py [--tree DIR] [--label NAME]

For (B, T, d, H) = (16, 151, 256, 4) and (16, 76, 360, 4), bf16, dropout
0.1 in training, no residual, with the lengths of `chip_smoke.py`'s train
batch (its phase 11 call), it prints one JSON line with

- `wrapper_host_ms`: host time to issue one call through
  `fused_attention_module_3d` (`chip_smoke.host_ms`, no synchronisation);
- `entry_host_ms`: the same for the library's C entry alone over
  preallocated scratch and output (tensor maps and launches);
- `pieces_host_ms`: host time of each step of the wrapper on its own
  (argument checks, the parameter pointer array, the scratch size query,
  the two allocations, the angle table lookup, the stream query); what the
  wrapper takes beyond them and the C entry is autograd's `Function.apply`
  and the call's own Python;
- `direct_ms` and `entry_direct_ms`: one call between CUDA events, through
  the wrapper and through the C entry;
- `device_ms` and `stages_ms`: the device time of one call and of each of
  its kernels (torch.profiler).

Host readings are taken `--rounds` times each; the line gives them all.
`--tree DIR` imports `avec_tpu_torch` from DIR instead (for example an older
commit unpacked there with `git archive`), whose kernels build into DIR's
own `build/`: two versions compare within one chip call by running this
script once per tree, in turns. Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

SHAPES = ((16, 151, 256, 4), (16, 76, 360, 4))
DROP, SEED = 0.1, 77


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="directory holding the avec_tpu_torch to measure")
    ap.add_argument("--label", default=None, help="name printed with the line")
    ap.add_argument("--rounds", type=int, default=5)
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
    from avec_tpu_torch.ops import _cuda, attention_module as am
    from avec_tpu_torch.ops.attention_module import fused_attention_module_3d
    from avec_tpu_torch.ops.ffn import _threshold

    lens = cs.stage_lengths(cs.make_train_batch(
        np.random.RandomState(0))["inputs"][3])
    out = {"label": args.label or "repo",
           "package": os.path.dirname(avec_tpu_torch.__file__),
           "gpu": cs.gpu_line(), "shapes": {}}
    for b, t, d, heads in SHAPES:
        x, _, params = cs.att_inputs(b, t, d, torch.bfloat16, seed=t + 1)
        lt = torch.tensor(lens[0 if t == 151 else 1], dtype=torch.int32,
                          device=x.device)

        def wrapper():
            with torch.no_grad():
                fused_attention_module_3d(
                    x, *params, num_heads=heads, lengths=lt, seed=SEED,
                    drop_rate=DROP, deterministic=False, residual=False)

        entry = cs.att_fwd_launcher(x, params, heads, lt, DROP, SEED)
        _, _, size = am._lib()
        count = size(b, t, d, heads, 0, 1)
        pieces = {
            "checks": lambda: am._check(x, params, lt, heads),
            "pointer_array": lambda: am._pointers(params),
            "scratch_size": lambda: size(b, t, d, heads, 0, 1),
            "dropout_threshold": lambda: _threshold(1.0 - DROP),
            "allocations": lambda: (torch.empty(count, dtype=torch.float32,
                                                device=x.device),
                                    torch.empty_like(x)),
            "angle_table": lambda: am._interleaved_table(t, d, x.dtype,
                                                         x.device),
            "stream": lambda: _cuda.stream_ptr(x),
        }
        row = {"wrapper_host_ms": [], "entry_host_ms": [],
               "pieces_host_ms": {k: [] for k in pieces}}
        for _ in range(args.rounds):
            row["wrapper_host_ms"].append(cs.host_ms(wrapper))
            row["entry_host_ms"].append(cs.host_ms(entry))
            for k, fn in pieces.items():
                row["pieces_host_ms"][k].append(cs.host_ms(fn))
        row["direct_ms"] = cs.cuda_time_ms(wrapper)
        row["entry_direct_ms"] = cs.cuda_time_ms(entry)
        row["device_ms"], row["stages_ms"] = cs.device_time_ms(wrapper)
        med = {k: sorted(v)[len(v) // 2] for k, v in
               (("wrapper", row["wrapper_host_ms"]),
                ("entry", row["entry_host_ms"]))}
        parts = sum(sorted(v)[len(v) // 2]
                    for v in row["pieces_host_ms"].values())
        row["rest_host_ms"] = med["wrapper"] - med["entry"] - parts
        out["shapes"][f"T{t}_d{d}"] = row
        print(f"{out['label']} T={t} d={d}: host to issue a call "
              f"{med['wrapper']:.4f} ms through the wrapper (median of "
              f"{args.rounds}), {med['entry']:.4f} in the C entry, "
              f"{parts:.4f} in the wrapper's steps, {row['rest_host_ms']:.4f}"
              f" the rest; direct {row['direct_ms']:.4f} ms (C entry "
              f"{row['entry_direct_ms']:.4f}), device {row['device_ms']:.4f}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["stages_ms"].items()),
              flush=True)
        assert math.isfinite(row["device_ms"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
