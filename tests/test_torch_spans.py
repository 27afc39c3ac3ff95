"""The port's profiler spans (`avec_tpu_torch/utils/spans.py`): off without a
profiler, the closed vocabulary of a train step's phases under one, and the
kernel wrappers' `_cuda.launch`, which counts a launch only after its check
passes and spans it only under a profiler. The test marked `cuda` runs the
fused route on the card (no JAX there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m cuda -q
"""

import collections
import contextlib
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avec_tpu_torch.models import zoo
from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.utils import spans

torch.set_num_threads(2)

PHASES = ("avec/train/to_device", "avec/train/forward", "avec/train/loss",
          "avec/train/backward")


def _ao_trainer(device="cpu", **route):
    model = zoo.AudioEfficientConformerInterCTC(
        device=device, vocab_size=32, num_blocks=(1, 1, 1),
        interctc_blocks=[], **route)
    return Trainer(model=model, device=device, precision="float32")


def _batch(b=4):
    rng = np.random.RandomState(0)
    alen = np.array([4000, 3200, 3600, 2800][:b], np.int32)
    return {"inputs": [(rng.randn(b, 4000) * 0.1).astype(np.float32), alen],
            "targets": (rng.randint(1, 32, size=(b, 3)).astype(np.int32),
                        np.array([3, 2, 3, 2][:b], np.int32))}


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=list(activities)) as prof:
            fn()
    return [e for e in prof.events() if e.name.startswith("avec/")
            and e.device_type == torch.autograd.DeviceType.CPU]


@contextlib.contextmanager
def _record_function_calls():
    """The names `record_function` was constructed with meanwhile."""
    names, real = [], torch.autograd.profiler.record_function

    class Spy(real):
        def __init__(self, name, *args):
            names.append(name)
            super().__init__(name, *args)

    torch.autograd.profiler.record_function = Spy
    try:
        yield names
    finally:
        torch.autograd.profiler.record_function = real


@contextlib.contextmanager
def _launches_kept():
    saved = collections.Counter(_cuda.launches)
    try:
        yield
    finally:
        _cuda.launches.clear()
        _cuda.launches.update(saved)


def test_span_without_profiler_is_the_shared_null_context():
    off = spans.span("avec/train/step")
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("avec/kernel/fused_ffn_fwd") is off


def test_train_step_without_profiler_makes_no_span():
    trainer = _ao_trainer()
    with _record_function_calls() as names:
        trainer.train_step(_batch(), accumulated_steps=2)
    assert not [n for n in names if n.startswith("avec/")]


def test_train_step_spans_under_profiler_nest_and_count():
    """One step of two micro-batches: one step span, two of each
    micro-batch phase inside its micro-batch inside the step, the norm and
    the optimizer after them, and no name outside the vocabulary."""
    trainer = _ao_trainer()
    batch = _batch()
    events = _profiled(lambda: trainer.train_step(batch, accumulated_steps=2))
    names = collections.Counter(e.name for e in events)
    assert set(names) <= set(spans.TRAIN)
    assert names == {"avec/train/step": 1, "avec/train/micro": 2,
                     **{p: 2 for p in PHASES}, "avec/train/grad_norm": 1,
                     "avec/train/optimizer": 1}
    at = {e.name: [] for e in events}
    for e in sorted(events, key=lambda e: e.time_range.start):
        at[e.name].append((e.time_range.start, e.time_range.end))
    (s0, s1), = at["avec/train/step"]
    micros = at["avec/train/micro"]
    for m0, m1 in micros:
        assert s0 <= m0 < m1 <= s1
    for i, (m0, m1) in enumerate(micros):
        inside = [at[p][i] for p in PHASES]
        assert all(m0 <= a < b <= m1 for a, b in inside)
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(inside, inside[1:]))
    for name in ("avec/train/grad_norm", "avec/train/optimizer"):
        (a, b), = at[name]
        assert micros[-1][1] <= a < b <= s1


def test_launch_counts_after_check_and_spans_under_profiler():
    """A stub C call: rc 0 counts one under each name, an error raises and
    counts nothing; the span is recorded only under a profiler, named by
    the first name."""
    def call(rc):
        with _cuda.launch("stub_dq", "stub_dkv"):
            _cuda.check(rc, "stub_dq")

    with _launches_kept():
        with _record_function_calls() as names:
            call(0)
        assert not names
        assert _cuda.launches["stub_dq"] == 1
        assert _cuda.launches["stub_dkv"] == 1
        with pytest.raises(RuntimeError, match="stub_dq: CUDA error 3"):
            call(3)
        assert _cuda.launches["stub_dq"] == 1
        events = _profiled(lambda: call(0))
        assert [e.name for e in events] == ["avec/kernel/stub_dq"]
        assert _cuda.launches["stub_dkv"] == 2
        with pytest.raises(RuntimeError):
            _profiled(lambda: call(1))
        assert _cuda.launches["stub_dq"] == 2


@pytest.mark.cuda
def test_fused_step_has_one_kernel_span_per_launch():
    """On the card, a bf16 AO step on the fused routes under the profiler
    (CPU and CUDA): one `avec/kernel/<name>` span per count that the step
    adds to `_cuda.launches[name]`, forward and backward alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    model = zoo.AudioEfficientConformerInterCTC(
        device="cuda", vocab_size=32, num_blocks=(2, 2, 1),
        interctc_blocks=[], fused_ffn=True, fused_att=True, fused_conv=True)
    trainer = Trainer(model=model, device="cuda", precision="bfloat16")
    batch = _batch()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with _launches_kept():
        _cuda.reset_launches()

        def step():
            trainer.train_step(batch, accumulated_steps=2)
            torch.cuda.synchronize()

        events = _profiled(step, (ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA))
        counted = dict(_cuda.launches)
    kernels = collections.Counter(e.name[len(spans.KERNEL):] for e in events
                                  if e.name.startswith(spans.KERNEL))
    assert counted == {k: 2 * v
                       for k, v in model.kernel_launches_per_step().items()}
    assert dict(kernels) == counted
