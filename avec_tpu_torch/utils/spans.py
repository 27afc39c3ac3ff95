"""Named spans of the port's host work, recorded as `torch.profiler` events.

`span(name)` is `torch.profiler.record_function(name)` while a profiler is
recording, and one shared null context otherwise: the check is the
profiler's enabled flag, so a span costs a flag read when nothing traces.
There is no switch of its own: spans are on exactly when a profiler is on
(`main.py --profile`, the benchmark's traced slice). The profiler keeps them
in memory with the rest of its events. As profiler events they share its
clock with the device's kernels, and a kernel's correlation id ties it to
the runtime call that launched it, which lies inside the spans the host was
in: so device time, device idle gaps and host syncs can be put down to a
span.

The names, a closed set, all under `avec/`:

- `avec/train/step`: `Trainer.train_step`, once per optimizer step;
- `avec/train/micro`: one micro-batch of `Trainer._forward_backward`;
- `avec/train/to_device`, `avec/train/forward`, `avec/train/loss` (the
  losses and the auxiliary losses harvested with them),
  `avec/train/backward`: the phases of a micro-batch, in that order;
- `avec/train/all_reduce`: the data-parallel gradient and loss all-reduce;
- `avec/train/grad_norm` (the norm and the clip), `avec/train/optimizer`,
  `avec/train/ema`: the phases after the micro-batches;
- `avec/kernel/<name>`: one call of a hand-written kernel's C entry
  (`ops/_cuda.py:launch`), named by its first entry in `_cuda.launches`.
"""

import contextlib

from torch.autograd import profiler as _profiler

TRAIN = ("avec/train/step", "avec/train/micro", "avec/train/to_device",
         "avec/train/forward", "avec/train/loss", "avec/train/backward",
         "avec/train/all_reduce", "avec/train/grad_norm",
         "avec/train/optimizer", "avec/train/ema")
KERNEL = "avec/kernel/"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a profiler event while a profiler
    is on; the shared null context while none is."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF

