"""Finds a cell's pieces by the names in BENCHMARK.json: its configuration
(`configs/<config>.json`, whose "family" names `families/<family>.py`,
what depends on the model), its traffic mix (`traffic/<traffic>.json`,
whose "driver" names `drivers/<driver>.py`), its correctness limits
(`limits/<workload>.json`) and one reader per per-layer metric
(`metrics/<metric>.py`, a function `read(ctx)` that returns a number or
None). A cell, a mix, a metric or a configuration of a new architecture
is added by adding files and entries."""

import gc
import importlib.util
import json
import os
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "avec_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_file(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_family(here: str, config: dict, source: str):
    """The module `families/<family>.py` that the configuration names."""
    name = config.get("family")
    path = os.path.join(here, "families", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{source} names the family {name!r}: "
                                f"no file {path}")
    return load_module(path, f"bench_family_{name}")


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, bench: dict, workload: str, here: str = HERE):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                           f"{sorted(by_name)}")
        self.workload = by_name[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        root = os.path.dirname(here)
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.family = load_family(here, self.config, self.config_entry["file"])
        self.traffic = load_json(os.path.join(
            here, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(here, "limits",
                                             workload + ".json"))
        self.driver = load_module(
            os.path.join(here, "drivers", self.traffic["driver"] + ".py"),
            "bench_driver_" + self.traffic["driver"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.readers = {m["name"]: load_module(
            os.path.join(here, "metrics", m["name"] + ".py"),
            "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `avec_tpu_torch` is not `avec_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def read_metrics(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """The per-layer metrics whose readers found something to read."""
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every compared number is at or under its limit (a number
    that is missing or not finite fails)."""
    ok = True
    for key, limit in limits.items():
        v = numbers.get(key)
        if v is None or not (v == v) or v == float("inf") or v > limit:
            ok = False
    return ok


def release() -> None:
    """Return the memory of the program's dropped objects to the card."""
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()
