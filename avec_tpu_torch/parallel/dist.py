"""Process groups, batch sharding and host collectives (port of
avec_tpu/parallel/mesh.py).

The JAX package shards the batch over the 'data' axis of a device mesh and
lets GSPMD insert the collectives (gradient averaging, sync-BN statistics);
the reference it mirrors used torch DDP over NCCL, SyncBatchNorm and a
DistributedSampler (mesh.py:11-20). Here each rank is one process with a
`torch.distributed` process group:

  * `init_distributed` starts the group with the backend the caller names:
    "nccl" for one card per rank, "gloo" for CPU tensors or for ranks that
    share one card. It never falls back from one backend to the other;
  * `shard_batch` gives a rank its slice of an already padded host batch;
  * BatchNorm (`ops/layers.py`) and the fused convolution module
    (`ops/conv_module.py:fused_conv_module_3d_dp`) all-reduce their batch
    statistics; `train/model.py:Trainer(data_parallel=True)` all-reduces the
    gradients once per step;
  * `process_allgather`, `broadcast_host_object` and `sync_global_devices`
    move host objects and synchronise ranks;
  * `spawn` runs a function on N local ranks, for tests and for
    `chip_smoke.py`.

Tensor parallelism (the JAX `param_shardings` and GPT rules) is not ported.
"""

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
COLLECTIVE_TIMEOUT_S = 600         # a collective that waits longer fails
GRACE_S = 3.0                      # after a rank fails, others may report


def init_distributed(backend: str, world_size: int, rank: int,
                     init_method: str) -> None:
    """Join the default process group (mesh.py:34, in place of
    `torch.distributed.init_process_group` of the reference's main.py).

    `init_method` is a rendezvous URL, `tcp://host:port` or
    `file:///path`. A collective that waits longer than
    COLLECTIVE_TIMEOUT_S fails."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA; use gloo for CPU "
                           "tensors")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))


def _on() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in `group` (None: the default group); 0 without
    a process group."""
    return dist.get_rank(group) if _on() else 0


def world_size(group=None) -> int:
    """Ranks in `group` (None: the default group); 1 without a process
    group."""
    return dist.get_world_size(group) if _on() else 1


def shard_batch(batch: Any, group=None) -> Any:
    """This rank's slice of a host batch that is already padded
    (mesh.py:71-87): every leaf with a leading batch dimension that the world
    size divides is cut into equal contiguous slices along it; any other leaf
    (a scalar, or a batch dimension the world size does not divide) goes
    whole to every rank. Dicts, lists and tuples are walked; numpy arrays and
    tensors are sliced as they are, never re-padded, so every rank keeps the
    batch's padded length and batch statistics count the padding rows as the
    single-process step does."""
    r, w = rank(group), world_size(group)
    if w == 1:
        return batch

    def take(a):
        if isinstance(a, dict):
            return {k: take(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(take(v) for v in a)
        shape = getattr(a, "shape", None)
        if shape is None or len(shape) == 0 or shape[0] % w:
            return a
        n = shape[0] // w
        return a[r * n:(r + 1) * n]

    return take(batch)


def process_allgather(obj: Any, group=None) -> List[Any]:
    """Every rank's `obj`, in rank order (mesh.py:236, the reference's
    all_gather_object); [obj] without a process group."""
    if world_size(group) == 1:
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_host_object(obj: Any, root: int = 0, group=None) -> Any:
    """Rank `root`'s `obj` on every rank (mesh.py:260, the reference's
    broadcast_object_list)."""
    if world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root, group=group)
    return box[0]


def sync_global_devices(name: str = "barrier", group=None) -> None:
    """Wait until every rank of `group` reaches this call (mesh.py:228, the
    reference's torch.distributed.barrier). `name` labels the barrier for
    the reader, as in the JAX package."""
    del name
    if world_size(group) > 1:
        dist.barrier(group=group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group`; the cotangent is summed the same way
    (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


def _rank_device(device: str, r: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", r % torch.cuda.device_count())
    return dev


def _rank_main(fn, r, world, backend, device, init_method, args, out):
    """One rank: join the group, run fn, send back its result or error as
    pickled bytes (tensors go by value, so nothing is left for the parent to
    fetch from a process that has exited)."""
    try:
        dev = _rank_device(device, r)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed(backend, world, r, init_method)
        payload = pickle.dumps(fn(dev, *args))
        out.put((r, True, payload))
    except Exception as exc:  # reported to the parent, which re-raises it
        tb = traceback.format_exc()
        exc.add_note(f"raised on rank {r} of {world}:\n{tb}")
        try:
            payload = pickle.dumps(exc)
        except (pickle.PicklingError, TypeError, AttributeError):
            payload = pickle.dumps(RuntimeError(f"rank {r}: {tb}"))
        out.put((r, False, payload))
    finally:
        if _on():
            dist.destroy_process_group()


def _silent(procs, reported) -> List[int]:
    """Ranks whose process ended with an error code and reported nothing."""
    return [r for r, p in enumerate(procs)
            if r not in reported and p.exitcode not in (None, 0)]


def spawn(fn: Callable, world_size: int, backend: str, device: str, *args,
          timeout: float = 900.0) -> List[Any]:
    """Run `fn(device, *args)` on `world_size` local ranks and return the
    results in rank order.

    Each rank is a fresh process (`multiprocessing`'s "spawn" start method)
    in a process group of `backend`, joined through a `file://` rendezvous in
    a temporary directory, so concurrent callers never compete for a TCP
    port. `device` is "cpu", "cuda" (rank r on card r) or "cuda:i" (every rank
    on card i). `fn` must be importable by name from a module that the ranks
    can import cheaply; results travel back pickled.

    When a rank fails, the others get GRACE_S seconds to report (a peer
    blocked in a collective fails too), then every rank still running is
    stopped and the first error is raised here: a rank that died without a
    report (the cause of its peers' broken connections), else the first
    exception reported, with the rank's traceback as a note. After `timeout`
    seconds every rank is stopped and TimeoutError raised."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS}")
    ctx = multiprocessing.get_context("spawn")
    results, errors, silent = {}, {}, []
    with tempfile.TemporaryDirectory(prefix="avec_dist_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, device, init,
                                   args, out))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline, failed_at = time.monotonic() + timeout, None
        try:
            while len(results) < world_size:
                now = time.monotonic()
                if now > deadline or (failed_at is not None
                                      and now > failed_at + GRACE_S):
                    break
                try:
                    r, ok, payload = out.get(timeout=0.2)
                except queue.Empty:
                    if _silent(procs, {**results, **errors}):
                        failed_at = failed_at or now
                    continue
                if ok:
                    results[r] = pickle.loads(payload)
                else:
                    errors[r] = pickle.loads(payload)
                    failed_at = failed_at or now
            silent = _silent(procs, {**results, **errors})
        finally:
            for p in procs:
                p.join(timeout=30 if len(results) == world_size else 0)
                if p.is_alive():
                    p.terminate()
                    p.join()
            out.close()
    if silent:
        raise RuntimeError(f"rank {silent[0]} exited with code "
                           f"{procs[silent[0]].exitcode} without a result")
    if errors:
        raise next(iter(errors.values()))
    if len(results) < world_size:
        raise TimeoutError(f"ranks still running after {timeout} s")
    return [results[r] for r in range(world_size)]
