"""The harness on the CPU at small depths: the files that BENCHMARK.json
names, a cell and a configuration of a new architecture (the toy family of
`toy/`) added as files alone, seeded traffic, the modules a run loads, and
runs whose timed path is broken underneath coming out not correct.
Besides the listed cells, the drivers run the cells measured but not
listed (`unlisted_cells.json`: too noisy on the card so far; see PERF.md).
The test marked `cuda` runs a short cell on the card."""

import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import data, harness  # noqa: E402
from benchmark import run as bench_run  # noqa: E402

SMALL = {
    "av": dict(kind="av", vocab_size=32, v_num_blocks=[1, 1],
               a_num_blocks=[1, 1, 1], f_num_blocks=1, v_interctc_blocks=[1],
               a_interctc_blocks=[2], f_interctc_blocks=[1],
               att_type="patch"),
    "ao": dict(kind="ao", vocab_size=32, a_num_blocks=[2, 1, 1],
               a_interctc_blocks=[], att_type="patch"),
}
TRAFFIC = {
    "train": {"utterances_per_step": 4, "seconds": [0.5, 1.0],
              "label_ids": [1, 31]},
    "transcribe": {"files": 16, "outstanding": 8, "max_batch": 4,
                   "warmup_requests": 8, "trace_seconds": 1,
                   "seconds": [0.5, 1.0]},
    "serve": {"rate": 4.0, "pool": 8, "max_batch": 4, "warmup_seconds": 1,
              "trace_seconds": 1, "seconds": [0.5, 1.0]},
}
LISTED = harness.benchmark_file(ROOT)
HERE = os.path.join(ROOT, "benchmark")
TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")


def _with_unlisted(bench):
    """BENCHMARK.json with the unlisted cells and their metrics added."""
    extra = harness.load_json(os.path.join(os.path.dirname(__file__),
                                           "unlisted_cells.json"))
    out = json.loads(json.dumps(bench))
    out["configs"] += extra["configs"]
    out["workloads"] += extra["workloads"]
    out["end_to_end"] += extra["end_to_end"]
    by_name = {m["name"]: m for m in out["per_layer"]}
    for m in extra["per_layer"]:
        if m["name"] in by_name:
            by_name[m["name"]]["workloads"] += m["workloads"]
        else:
            out["per_layer"].append(m)
    for m in out["end_to_end"]:
        m["workloads"] = m.get("workloads", []) + extra[
            "end_to_end_workloads"].get(m["name"], [])
        if not m["workloads"]:
            del m["workloads"]
    return out


BENCH = _with_unlisted(LISTED)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _small(workload):
    cell = harness.Cell(BENCH, workload)
    train = dict(cell.config["train"], precision="float32")
    return {"config": {"model": SMALL[cell.config["model"]["kind"]],
                       "train": train},
            "traffic": TRAFFIC[cell.traffic["driver"]]}


def _run(workload, seed=2 ** 31 + 5, trace=False):
    return bench_run.run(workload, seed, 1.0, trace, torch.device("cpu"),
                         _small(workload), log=lambda *a, **k: None,
                         bench=BENCH)


def _family_names(driver: str) -> set:
    """The names a driver, and the serving module if it uses it, call on
    the family."""
    with open(driver) as f:
        text = f.read()
    if "served." in text:
        with open(os.path.join(HERE, "served.py")) as f:
            text += f.read()
    return set(re.findall(r"family\.(\w+)", text))


def test_every_cell_finds_its_files():
    assert {w["name"] for w in LISTED["workloads"]} <= set(WORKLOADS)
    names = set()
    for w in BENCH["workloads"]:
        cell = harness.Cell(BENCH, w["name"])
        assert cell.limits["limits"]
        assert hasattr(cell.driver, "Driver")
        assert {m["name"] for m in cell.per_layer} == set(cell.readers)
        assert cell.end_to_end and cell.per_layer
        names.add(w["name"])
    assert len(names) == len(BENCH["workloads"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in names
    for c in BENCH["configs"]:
        config = harness.load_json(os.path.join(ROOT, c["file"]))
        assert harness.load_family(HERE, config, c["file"])
    for w in BENCH["workloads"]:
        cell = harness.Cell(BENCH, w["name"])
        for name in _family_names(cell.driver.__file__):
            assert callable(getattr(cell.family, name)), (w["name"], name)
    for config in ({"family": "no_such_family"}, {}):
        with pytest.raises(FileNotFoundError, match="families"):
            harness.load_family(HERE, config, "x.json")
    generic = glob.glob(os.path.join(HERE, "drivers", "*.py")) + [
        os.path.join(HERE, f) for f in ("run.py", "harness.py", "served.py",
                                        os.path.join("reference",
                                                     "train.py"))]
    for path in generic:
        with open(path) as f:
            text = f.read()
        for word in ('["kind"]', "['kind']", "models.zoo", "models import",
                     '"video"', "inputs[", "len(inputs)"):
            assert word not in text, (path, word)


def test_a_cell_added_as_files_alone_loads(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark")
    bench = json.loads(json.dumps(LISTED))
    first = bench["workloads"][0]
    traffic = harness.load_json(os.path.join(
        ROOT, "benchmark", "traffic", first["traffic"] + ".json"))
    traffic["seconds"] = [1.0, 3.0]
    (root / "benchmark" / "traffic" / "short_mix.json").write_text(
        json.dumps(traffic))
    shutil.copy(os.path.join(ROOT, "benchmark", "limits",
                             first["name"] + ".json"),
                root / "benchmark" / "limits" / "new_cell.json")
    bench["workloads"].append(dict(first, name="new_cell",
                                   traffic="short_mix"))
    for m in bench["per_layer"] + bench["end_to_end"]:
        if first["name"] in m.get("workloads", []):
            m["workloads"].append("new_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(harness.benchmark_file(str(root)), "new_cell",
                        str(root / "benchmark"))
    assert cell.traffic["seconds"] == [1.0, 3.0]
    assert cell.readers and cell.end_to_end


def _hashes(root) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


_TOY_RUNS = """
import json, sys
sys.path.insert(0, %(root)r)
import torch
from benchmark import harness, run
from avec_tpu_torch.train import model as tm
assert harness.__file__.startswith(%(root)r), harness.__file__
cpu, quiet, out = torch.device("cpu"), lambda *a, **k: None, {}
for trace in (False, True):
    out[trace] = run.run("toy_train", %(seed)d, 1.0, trace, cpu, log=quiet)
split = tm._split_micro
tm._split_micro = lambda batch, accum: [
    {"inputs": [x[:x.shape[0] // 2] for x in m["inputs"]],
     "targets": tuple(y[:y.shape[0] // 2] for y in m["targets"])}
    for m in split(batch, accum)]
out["half_batch"] = run.run("toy_train", %(seed)d, 1.0, False, cpu,
                            log=quiet)
out["forbidden"] = harness.forbidden_modules()
from torch.utils.flop_counter import FlopCounterMode
from benchmark.reference.model import Ctx
family = harness.Cell(harness.benchmark_file(%(root)r), "toy_train",
                      %(root)r + "/benchmark").family
spec = harness.load_json(%(root)r + "/benchmark/configs/toy.json")["model"]
_, state = family.build_model(spec, {}, 1, cpu)
out["flops"] = []
for batch, samples in ((2, 8000), (3, 12345)):
    inputs = [torch.randn(batch, samples), torch.full((batch,), samples)]
    with FlopCounterMode(display=False) as counter:
        family.reference_forward(Ctx(False), state, {}, spec, inputs)
    out["flops"].append([family.forward_flops(spec, batch, samples),
                         counter.get_total_flops()])
print(json.dumps(out, default=float))
"""


def test_a_new_architecture_added_as_files_alone_runs(tmp_path):
    """A configuration of a model outside the port's zoo (`toy/`: its
    family, reference, configuration, traffic and limits) is added to a
    copy of the benchmark by new files and BENCHMARK.json entries alone,
    with no file that was there changed, and runs on the CPU through the
    unchanged train driver: correct, with its end-to-end and per-layer
    metrics and FLOPs equal to its reference's products; with half of each
    micro-batch dropped, not correct."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "avec_tpu_torch"), root / "avec_tpu_torch")
    before = _hashes(root / "benchmark")
    for path in glob.glob(os.path.join(TOY, "*", "*.*")):
        dest = root / "benchmark" / os.path.relpath(path, TOY)
        assert not dest.exists(), dest
        shutil.copy(path, dest)
    bench = json.loads(json.dumps(LISTED))
    bench["configs"].append({
        "name": "toy",
        "source": "https://www.cs.toronto.edu/~graves/icml_2006.pdf",
        "file": "benchmark/configs/toy.json", "reduced": [],
        "why": "two linear layers over log-mels: a family outside the zoo"})
    bench["workloads"].append({
        "name": "toy_train", "config": "toy", "traffic": "toy_4x2",
        "chips": 1, "why": "Trainer.train_step on the toy family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_audio_s_per_s", "mfu.train"):
            m["workloads"].append("toy_train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    out = subprocess.run(
        [sys.executable, "-c", _TOY_RUNS % {"root": str(root),
                                            "seed": 2 ** 31 + 21}],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    after = _hashes(root / "benchmark")
    assert {k: after[k] for k in before} == before
    assert res["forbidden"] == []
    untraced, traced = res["false"], res["true"]
    assert untraced["correct"] and traced["correct"], (untraced["compared"],
                                                       traced["compared"])
    assert untraced["metrics"]["train_audio_s_per_s"]["value"] > 0
    assert set(traced["metrics"]) == {"mfu.train"}
    assert traced["metrics"]["mfu.train"]["value"] > 0
    assert not res["half_batch"]["correct"], res["half_batch"]["compared"]
    for got, want in res["flops"]:
        assert got == pytest.approx(want, rel=1e-9)


def test_traffic_is_fixed_by_the_seed():
    tr = {"seconds": [2.0, 8.0], "labels_per_second": 4,
          "label_ids": [1, 255]}
    a = data.utterance_samples(tr, 64, 2 ** 31 + 9)
    b = data.utterance_samples(tr, 64, 2 ** 31 + 9)
    c = data.utterance_samples(tr, 64, 2 ** 31 + 10)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))    # same sizes, new order
    la, _ = data.labels(a, tr, 3)
    lb, _ = data.labels(a, tr, 3)
    lc, _ = data.labels(a, tr, 4)
    assert np.array_equal(la, lb) and not np.array_equal(la, lc)
    ga = data.arrival_gaps(50.0, 500, 1)
    gc = data.arrival_gaps(50.0, 500, 2)
    assert np.array_equal(np.sort(ga), np.sort(gc))
    assert not np.array_equal(ga, gc)
    assert abs(ga.mean() - 1 / 50.0) < 2e-3
    xa = data.audio(a[:3], 5, "cpu")
    assert torch.equal(xa, data.audio(a[:3], 5, "cpu"))
    assert not torch.equal(xa, data.audio(a[:3], 6, "cpu"))


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run, served, trace, costs\n"
        "from benchmark.families import avec\n"
        "from benchmark.reference import model, train, wav\n"
        "b = harness.benchmark_file(%r)\n"
        "for w in b['workloads']:\n"
        "    harness.Cell(b, w['name'])\n"
        "import avec_tpu_torch.serve, avec_tpu_torch.train.model\n"
        "import avec_tpu_torch.models.zoo\n"
        "print(harness.forbidden_modules())\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "avec_tpu")
    for name in ("avec_tpu_torch", "avec_tpu_torch.ops"):
        assert name.split(".")[0] not in harness.FORBIDDEN


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    res = _run(workload, trace=True)
    assert res["correct"], res["compared"]
    assert res["metrics"]


@pytest.fixture
def broken(monkeypatch):
    def plant(fault):
        if fault == "state_unchanged":
            from avec_tpu_torch.train.optim import Optimizer

            monkeypatch.setattr(Optimizer, "update",
                                lambda self, step: self.learning_rate(step))
        elif fault == "half_batch":
            from avec_tpu_torch.train import model as tm

            split = tm._split_micro

            def halves(batch, accum):
                def half(a):
                    if isinstance(a, dict):
                        return {k: half(v) for k, v in a.items()}
                    if isinstance(a, (list, tuple)):
                        return type(a)(half(v) for v in a)
                    return a[:max(1, a.shape[0] // 2)]
                return [half(m) for m in split(batch, accum)]

            monkeypatch.setattr(tm, "_split_micro", halves)
        elif fault == "token_altered":
            from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder

            call = CTCGreedySearchDecoder.__call__

            def altered(self, outputs, from_logits=True):
                return [list(row) + [1] for row in call(self, outputs,
                                                        from_logits)]

            monkeypatch.setattr(CTCGreedySearchDecoder, "__call__", altered)
    return plant


FAULTS = [(w, f) for w in WORKLOADS for f in (
    ("state_unchanged", "half_batch")
    if harness.Cell(BENCH, w).traffic["driver"] == "train"
    else ("token_altered",))]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault, broken):
    broken(fault)
    res = _run(workload)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_in_the_programs_place_is_not_correct(workload):
    """The reference in float8 where the program stands, through the cell's
    own comparison and limits, at a small size (on the card it is read at
    the cell's size by `benchmark/readings.py --control fp8`)."""
    cell = harness.Cell(BENCH, workload)
    for key, value in _small(workload).items():
        getattr(cell, key).update(value)
    drv = cell.driver.Driver(cell, 2 ** 31 + 11, torch.device("cpu"), ROOT)
    if cell.traffic["driver"] != "train":
        drv.window(1.0)
    drv.release_program()
    assert not harness.verdict(drv.control("fp8"), cell.limits["limits"])


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         LISTED["workloads"][0]["name"],
         "--seed", str(2 ** 31 + 77), "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
