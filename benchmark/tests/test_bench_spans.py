"""`benchmark/spans.py` and the readers of the program's spans on a
hand-built slice (times in microseconds): one step of one micro-batch,
kernels put down to their spans through the correlation ids of their
launches, idle gaps to the innermost `avec/train/` span at their
midpoints, syncs counted inside the step, and None, never 0, where the
slice has no spans or no kernels."""

import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, spans  # noqa: E402

READERS = ("idle_ms.forward.train", "idle_ms.loss.train",
           "idle_ms.backward.train", "idle_ms.optimizer.train",
           "syncs_per_step.train", "train_kernel_spans_roofline")

SPANS = [("avec/train/step", 0, 1000), ("avec/train/micro", 0, 800),
         ("avec/train/to_device", 0, 10), ("avec/train/forward", 10, 300),
         ("avec/train/loss", 300, 500), ("avec/train/backward", 500, 790),
         ("avec/train/grad_norm", 800, 850),
         ("avec/train/optimizer", 850, 990),
         ("avec/kernel/fused_ffn_fwd", 50, 60),
         ("avec/kernel/fused_ffn_bwd", 600, 610)]
CALLS = [("cudaLaunchKernel", 55, 58, 1), ("cudaLaunchKernel", 310, 312, 2),
         ("cudaStreamSynchronize", 320, 440, 0),
         ("cudaLaunchKernel", 605, 607, 3), ("cudaLaunchKernel", 700, 702, 4),
         ("cudaLaunchKernel", 860, 862, 5),
         ("cudaDeviceSynchronize", 990, 1100, 0)]
OPS = [("ffn_fwd_prep_kernel", 100, 200, 1, True),
       ("elementwise_kernel", 450, 480, 2, False),
       ("ffn_bwd_hidden_kernel", 650, 700, 3, True),
       ("reduce_kernel", 760, 790, 4, False),
       ("multi_tensor_apply_kernel", 900, 920, 5, False),
       ("conv_reduce_kernel", 930, 940, 99, True)]


def _records(spans_=SPANS, ops=OPS):
    return ([("span", *s) for s in spans_] + [("call", *c) for c in CALLS]
            + [("op", *o) for o in ops])


def _read(records, bound_s=7.5e-5):
    ctx = {"kind": "train", "trace": {"spans": spans.reduce(records)},
           "kernel_bound_s": bound_s}
    out = {}
    for name in READERS:
        mod = harness.load_module(
            os.path.join(ROOT, "benchmark", "metrics", name + ".py"),
            "bench_metric_" + name.replace(".", "_"))
        out[name] = mod.read(ctx)
    return out


def test_reduce_puts_device_time_idle_and_syncs_down_to_spans():
    got = spans.reduce(_records())
    by = got["by_span"]
    assert got["steps"] == 1
    assert by["avec/train/micro"]["count"] == 1
    assert by["avec/train/forward"]["host_s"] == pytest.approx(290e-6)
    # kernels through the correlation ids of their launches
    assert by["avec/kernel/fused_ffn_fwd"]["device_s"] == pytest.approx(1e-4)
    assert by["avec/kernel/fused_ffn_bwd"]["device_s"] == pytest.approx(5e-5)
    assert by["avec/train/forward"]["device_s"] == pytest.approx(1e-4)
    assert by["avec/train/backward"]["device_s"] == pytest.approx(8e-5)
    assert by["avec/train/step"]["device_s"] == pytest.approx(2.3e-4)
    assert got["kernel_device_s"] == pytest.approx(1.5e-4)
    assert got["unmatched_kernel_s"] == pytest.approx(1e-5)
    assert got["uncorrelated_s"] == pytest.approx(1e-5)
    # each gap to the innermost avec/train/ span at its midpoint
    idle = {k: v["idle_s"] * 1e6 for k, v in by.items()}
    assert idle["avec/train/forward"] == pytest.approx(100)
    assert idle["avec/train/loss"] == pytest.approx(250)
    assert idle["avec/train/backward"] == pytest.approx(230)
    assert idle["avec/train/grad_norm"] == pytest.approx(110)
    assert idle["avec/train/optimizer"] == pytest.approx(70)
    assert idle["avec/train/step"] == idle["avec/train/micro"] == 0
    assert idle["avec/kernel/fused_ffn_fwd"] == 0
    assert got["unattributed_idle_s"] == 0
    # the slice runs from the step's start to its end (the last operation
    # ends before it): 1000 us, 240 us busy
    assert got["idle_s"] == pytest.approx(760e-6)
    assert sum(v["idle_s"] for v in by.values()) == pytest.approx(760e-6)
    # a second step with no work: the gap between the steps is in no span
    two = spans.reduce(_records([*SPANS, ("avec/train/step", 2000, 2100)]))
    assert two["steps"] == 2
    assert two["idle_s"] == pytest.approx(1860e-6)
    assert two["unattributed_idle_s"] == pytest.approx(1160e-6)
    assert (sum(v["idle_s"] for v in two["by_span"].values())
            + two["unattributed_idle_s"]) == pytest.approx(two["idle_s"])
    # syncs by the span they start in
    assert by["avec/train/loss"]["syncs"] == 1
    assert by["avec/train/optimizer"]["syncs"] == 1
    assert by["avec/train/step"]["syncs"] == 2
    assert by["avec/train/forward"]["syncs"] == 0


def test_readers_per_step():
    got = _read(_records())
    assert got == {
        "idle_ms.forward.train": pytest.approx(0.1),
        "idle_ms.loss.train": pytest.approx(0.25),
        "idle_ms.backward.train": pytest.approx(0.23),
        "idle_ms.optimizer.train": pytest.approx(0.18),
        "syncs_per_step.train": 2.0,
        "train_kernel_spans_roofline": pytest.approx(50.0)}
    two = _records([*SPANS, ("avec/train/step", 2000, 2100)])
    assert _read(two)["syncs_per_step.train"] == 1.0


def test_readers_none_without_spans_or_kernels():
    no_spans = [r for r in _records() if r[0] != "span"]
    assert _read(no_spans) == {name: None for name in READERS}
    no_kernels = _records(SPANS, [o for o in OPS if not o[4]])
    got = _read(no_kernels)
    assert got["train_kernel_spans_roofline"] is None
    assert got["syncs_per_step.train"] == 2.0
    assert _read(_records(), bound_s=0.0)["train_kernel_spans_roofline"] is None
    assert _read([])["idle_ms.forward.train"] is None
    for name in READERS:
        mod = harness.load_module(
            os.path.join(ROOT, "benchmark", "metrics", name + ".py"), "m")
        assert mod.read({"trace": {}}) is None


def test_plain_keeps_spans_runtime_calls_and_device_operations():
    from torch.autograd import DeviceType

    def ev(name, s, t, dev=DeviceType.CPU, id_=0, user=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            start=s, end=t), device_type=dev, id=id_,
            is_user_annotation=user)

    events = [ev("avec/train/step", 0, 100),
              ev("avec/train/step", 0, 100, DeviceType.CUDA, user=True),
              ev("aten::mul", 5, 6, id_=7),
              ev("cudaLaunchKernel", 10, 11, id_=7),
              ev("void ns::(anonymous namespace)::ffn_fwd_prep_kernel<2>(A)",
                 20, 30, DeviceType.CUDA, 7),
              ev("void at::native::elementwise_kernel<4>(float)", 30, 40,
                 DeviceType.CUDA, 8),
              ev("Memset (Device)", 40, 40, DeviceType.CUDA, 9)]
    got = spans.plain(events, {"ffn_fwd_prep_kernel"})
    assert sorted(got, key=str) == sorted([
        ("span", "avec/train/step", 0, 100),
        ("call", "cudaLaunchKernel", 10, 11, 7),
        ("op", events[4].name, 20, 30, 7, True),
        ("op", events[5].name, 30, 40, 8, False)], key=str)
