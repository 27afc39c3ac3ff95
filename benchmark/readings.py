"""The readings that a cell's correctness limits are set from, many seeds
in one process (set-up is long, the card is paid by the second):

    python3 benchmark/readings.py --workload av_train --seeds 1-12
    python3 benchmark/readings.py --workload av_train --seeds 1-3 \\
        --control fp8        # or half: the faults planted in the reference

Without --control, each seed runs the cell's set-up and the check that a
run makes (serving cells first serve `--seconds` at the cell's load), and
prints the compared numbers: the program's readings, of which the limit's
lower end is the largest. With --control the reference computed in float8
(fp8) or on half of each micro-batch (half) takes the program's place;
their smallest reading is the upper end. Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--base", type=int, default=2 ** 31 + 1000)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness
    from avec_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _cuda.build()
    bench = harness.benchmark_file(ROOT)
    cell = harness.Cell(bench, args.workload, HERE)
    rows = []
    for s in seeds_of(args.seeds):
        seed = args.base + s
        t0 = time.perf_counter()
        drv = cell.driver.Driver(cell, seed, torch.device("cuda"), ROOT)
        if hasattr(drv, "capture"):
            drv.window(args.seconds)
        drv.release_program()
        numbers = drv.control(args.control) if args.control else drv.check()
        row = {"seed": seed, "control": args.control or None,
               "numbers": numbers, "s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del drv
        torch.cuda.empty_cache()
    keys = [k for k, v in rows[0]["numbers"].items()
            if isinstance(v, (int, float))]
    print(json.dumps({"workload": args.workload,
                      "control": args.control or None,
                      "max": {k: max(r["numbers"][k] for r in rows)
                              for k in keys},
                      "min": {k: min(r["numbers"][k] for r in rows)
                              for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
