"""The sweep that found the rate of an open-loop serving cell: one process
serves the cell's traffic at each rate in turn and prints, per rate, the
requests due, the p50 and p95 latency, how long the queue took to drain
after the last arrival, and the generator's lateness:

    python3 benchmark/sweep.py --workload av_serve --rates 40,60,80,100 \\
        --seconds 20

A backlog that grows through a run shows as a drain time that grows with
the rate and a p95 far above the p50. The cell runs at about four fifths of
the highest rate without one. Not part of a benchmark run.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=2 ** 31 + 99)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from avec_tpu_torch.ops import _cuda
    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _cuda.build()
    cell = harness.Cell(harness.benchmark_file(ROOT), args.workload, HERE)
    rates = [float(r) for r in args.rates.split(",")]
    cell.traffic["rate"] = rates[0]
    drv = cell.driver.Driver(cell, args.seed, torch.device("cuda"), ROOT)
    for rate in rates:
        drv.rate = rate
        out = drv._run(args.seconds, args.seed + int(rate))
        lat = sorted(t - due for due, t, _ in out["done"].values())
        last_due = max(due for due, _, _ in out["done"].values())
        drain = max(t for _, t, _ in out["done"].values()) - last_due
        print(json.dumps({
            "rate": rate, "due": out["due"], "served": len(lat),
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p95_ms": 1e3 * lat[int(np.ceil(0.95 * len(lat))) - 1],
            "max_ms": 1e3 * lat[-1], "drain_s": drain,
            "late_max_ms": 1e3 * max(out["late"]),
            "batches": len(out["spans"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
