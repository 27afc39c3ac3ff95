"""Runs one cell of BENCHMARK.json once on this machine's card:

    python3 benchmark/run.py --workload av_train --seed 7 --seconds 30 \\
        --trace 0

The cell's pieces, its model family among them, are found by name
(`harness.Cell`).

Set-up (timed as `setup_s`): CUDA, the kernels (built into the checkout's
`build/` on a first run, loaded after), the model and the seeded weights,
the traffic, and the cell's first steps or requests, which warm every
shape the window uses. Then the window of `--seconds` measures the cell's
end-to-end metrics; with `--trace 1` a traced slice after it gives the
per-layer metrics and the breakdown. Last, with the program's state freed,
the plain reference decides `correct`: the numbers it compares and their
limits go to standard error and, last, into the result's line, which is
the last line of standard output.

Exits 2 without a result where there is no card or too few, and 3 where
JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        overrides=None, log=print, bench=None) -> dict:
    """One run of `workload`; the result's dict. `device`, `overrides`
    (merged into the configuration's and the traffic's dicts) and `bench`
    (in place of BENCHMARK.json) are for the CPU tests; a run on the card
    passes none of them."""
    import torch

    from benchmark import harness
    from benchmark import trace as tracing

    cell = harness.Cell(bench or harness.benchmark_file(ROOT), workload, HERE)
    for key, value in (overrides or {}).items():
        getattr(cell, key).update(value)
    if device is None:
        device = torch.device("cuda")
        torch.cuda.init()
        from avec_tpu_torch.ops import _cuda
        _cuda.build()
    driver = cell.driver.Driver(cell, seed, device, ROOT)
    setup_s = time.perf_counter() - T_START
    metrics = driver.window(seconds)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end if m["name"] in metrics}
    if any(m["name"] == "peak_gib" for m in cell.end_to_end):
        metrics["peak_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result = {"metrics": metrics}
    if trace:
        summary = tracing.traced(driver.slice, ROOT) if on_card else {
            "busy_s": 0.0, "window_s": 0.0, "launches": 0, "kernel_s": {},
            "device_ops": [], "idle_gaps": []}
        ctx = driver.layer_ctx(summary)
        result["metrics"] = harness.read_metrics(cell, ctx)
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["trace"] = {"busy_s": summary["busy_s"],
                           "window_s": summary["window_s"]}
    attempted, failed = driver.counts()
    driver.release_program()
    numbers = driver.check()
    limits = cell.limits["limits"]
    correct = bool(harness.verdict(numbers, limits))
    compared = {k: {"value": numbers.get(k), "limit": v}
                for k, v in limits.items()}
    for k, v in compared.items():
        log(f"compared {k}: {v['value']!r} limit {v['limit']!r}",
            file=sys.stderr)
    result.update(correct=correct, attempted=attempted, failed=failed,
                  peak=peak, compared=compared)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args(argv)
    _caches()
    import torch

    from benchmark import harness

    bench = harness.benchmark_file(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < chips[args.workload]):
        print("no CUDA device, or fewer than the cell needs: this benchmark "
              "runs on the card only", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark must not "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips[args.workload],
              "memory_peak_bytes": int(result["peak"])}
    if args.trace:
        device.update(busy_s=result["trace"]["busy_s"],
                      window_s=result["trace"]["window_s"])
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = result["compared"]
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
