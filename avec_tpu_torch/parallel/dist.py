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
  * `make_mesh` lays the ranks out as the JAX (data, model) grid and makes
    the process groups of its two axes;
  * `shard_batch` gives a rank its slice of an already padded host batch;
    `host_local_batch_to_global` assembles the rank-local batches of a
    sharded loader into one global batch of one padded shape;
  * BatchNorm (`ops/layers.py`) and the fused convolution module
    (`ops/conv_module.py:fused_conv_module_3d_dp`) all-reduce their batch
    statistics; `train/model.py:Trainer(data_parallel=True)` all-reduces the
    gradients once per step;
  * `process_allgather`, `broadcast_host_object` and `sync_global_devices`
    move host objects and synchronise ranks;
  * `spawn` runs a function on N local ranks, for tests and for
    `chip_smoke.py`.

Tensor parallelism over the mesh's model axis (the collectives of the
sharded layers, `param_shardings`, `shard_module`,
`gpt_tensor_parallel_rules`) is in `parallel/tensor_parallel.py`; those
three, `shard_tree` and `shard_like_params` are named here, as the JAX
module names them. The JAX placements `batch_sharding`,
`replicated_sharding` and `replicate` have no counterpart: each rank holds
its own tensors (`shard_batch` cuts a batch, `Trainer` broadcasts rank 0's
state).
"""

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
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


class Mesh:
    """The ranks laid out as the JAX ('data', 'model') grid (mesh.py:47-56):
    `data` and `model` are the process groups of this rank's column and row
    (None where the axis has one rank), `data_size` / `model_size` their
    sizes and `data_rank` / `model_rank` this rank's places on them."""

    def __init__(self, data, model, data_size: int, model_size: int,
                 data_rank: int, model_rank: int):
        self.data, self.model = data, model
        self.data_size, self.model_size = data_size, model_size
        self.data_rank, self.model_rank = data_rank, model_rank

    @property
    def shape(self):
        return {"data": self.data_size, "model": self.model_size}

    def __repr__(self):
        return (f"Mesh(data={self.data_size}, model={self.model_size}, "
                f"rank=({self.data_rank}, {self.model_rank}))")


def make_mesh(model_parallel: int = 1, group=None) -> Mesh:
    """The ranks of `group` (None: the default group; one rank without a
    process group) as a (world // model_parallel, model_parallel) grid, the
    model axis fastest as `reshape` lays out the JAX devices: ranks r with
    the same r // model_parallel form a model group, ranks with the same
    r % model_parallel a data group. Every rank of `group` must call it (it
    makes the groups). Raises ValueError when model_parallel does not divide
    the world size (mesh.py:55 asserts it)."""
    world = world_size(group)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world size {world}")
    me = rank(group)
    n_data = world // model_parallel
    if world == 1:
        return Mesh(None, None, 1, 1, 0, 0)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(world)))
    grid = np.asarray(ranks).reshape(n_data, model_parallel)
    if model_parallel == 1:
        return Mesh(group if group is not None else dist.group.WORLD, None,
                    n_data, 1, me, 0)
    data = model = None
    for j in range(model_parallel):             # columns: the data groups
        g = dist.new_group([int(r) for r in grid[:, j]])
        if j == me % model_parallel:
            data = g
    for i in range(n_data):                     # rows: the model groups
        g = dist.new_group([int(r) for r in grid[i]])
        if i == me // model_parallel:
            model = g
    return Mesh(data if n_data > 1 else None, model, n_data, model_parallel,
                me // model_parallel, me % model_parallel)


def padding_values(collate_fn) -> Any:
    """The padding value of each field of a `data.collate.CollateFn`'s
    batches, in the structure of its batch ({"inputs", "targets"}); 0 for
    a collate without field specs."""
    def of(params):
        if isinstance(params, dict):
            out = {k: p.get("padding_value", 0) for k, p in params.items()}
            return next(iter(out.values())) if len(out) == 1 else out
        outs = [p.get("padding_value", 0) for p in params]
        if len(outs) == 1:
            return outs[0]
        return tuple(outs) if isinstance(params, tuple) else outs

    if not hasattr(collate_fn, "inputs_params"):
        return 0
    return {"inputs": of(collate_fn.inputs_params),
            "targets": of(collate_fn.targets_params)}


def _flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """(leaves in order, rebuild(leaves) -> the same structure) of nested
    dicts, lists and tuples."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]

    def rebuild(flat):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(flat[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def _pad_to(a: np.ndarray, shape, batch_axis: int, value) -> np.ndarray:
    widths = [(0, 0 if d == batch_axis else int(n) - a.shape[d])
              for d, n in enumerate(shape)]
    if not any(w for _, w in widths):
        return a
    return np.pad(a, widths, constant_values=np.asarray(value, a.dtype))


def assemble_batch(batch: Any, mesh: Optional[Mesh] = None,
                   batch_axis: int = 0, padding: Any = 0
                   ) -> Tuple[Any, bool]:
    """`host_local_batch_to_global` and its branch: (batch, True) where each
    rank keeps its part, (the whole global batch, False) where the parts
    were gathered."""
    group = mesh.data if mesh is not None else (
        dist.group.WORLD if _on() else None)
    n = 1 if group is None else world_size(group)
    if n == 1:
        return batch, True
    leaves, rebuild = _flatten(batch)
    pads, _ = _flatten(padding)
    if len(pads) == 1:
        pads = pads * len(leaves)
    elif len(pads) != len(leaves):
        raise ValueError(f"{len(pads)} padding values for a batch of "
                         f"{len(leaves)} leaves")
    arrays = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                         else x) for x in leaves]
    shapes = process_allgather([a.shape for a in arrays], group)
    # the verdict every rank reaches from the same gathered shapes
    # (mesh.py:122-125): each leaf has a batch axis of one size everywhere
    keep = all(len(s) > batch_axis and s[batch_axis] == shapes[0][i]
               [batch_axis] for shp in shapes for i, s in enumerate(shp))
    padded = []
    for i, (a, value) in enumerate(zip(arrays, pads)):
        if a.ndim == 0:
            padded.append(a)
            continue
        target = [max(shp[i][d] for shp in shapes) for d in range(a.ndim)]
        padded.append(_pad_to(a, target, batch_axis, value))
    if keep:
        return rebuild(padded), True
    parts = process_allgather(padded, group)
    whole = [np.concatenate([p[i] for p in parts], axis=batch_axis)
             if padded[i].ndim > batch_axis else padded[i]
             for i in range(len(padded))]
    return rebuild(whole), False


def host_local_batch_to_global(batch: Any, mesh: Optional[Mesh] = None,
                               batch_axis: int = 0, padding: Any = 0) -> Any:
    """This rank's part of the global batch from its host-local loader
    batch (mesh.py:95-135; the reference's DistributedSampler slicing at the
    array level). One global batch has one padded shape: every non-batch
    dimension is padded to its largest size over the mesh's data ranks
    (their shapes gathered first), with `padding` (a number, or one per
    leaf in the batch's structure, as `padding_values` gives a collate's).
    Then the JAX rule: every rank reaches the same verdict from the
    gathered shapes before either branch. Where every leaf has a batch axis
    of one size on every rank (a rank is one device of the data axis, so
    this is JAX's "divisible"), each rank keeps its padded part; otherwise
    (a last partial batch) the parts are gathered, concatenated on the batch
    axis, and every rank gets the whole batch. Without a data axis the
    batch is returned as it is."""
    return assemble_batch(batch, mesh, batch_axis, padding)[0]


def shard_batch(batch: Any, group=None) -> Any:
    """This rank's slice of a host batch that is already padded
    (mesh.py:71-87): every leaf with a leading batch dimension that the world
    size divides is cut into equal contiguous slices along it; any other leaf
    (a scalar, or a batch dimension the world size does not divide) goes
    whole to every rank. Dicts, lists and tuples are walked; numpy arrays and
    tensors are sliced as they are, never re-padded, so every rank keeps the
    batch's padded length and batch statistics count the padding rows as the
    single-process step does. `group` may be a `Mesh`: the batch is then cut
    over its data group only, so every rank of a model group gets the same
    slice."""
    if isinstance(group, Mesh):
        if group.data is None:
            return batch
        group = group.data
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


from avec_tpu_torch.parallel.tensor_parallel import (  # noqa: E402,F401
    gpt_tensor_parallel_rules, param_shardings, shard_module)


def shard_tree(state: Any, shardings: Any, mesh: Mesh) -> Any:
    """A whole {name: tensor} state -> this rank's shards by `shardings`
    ({name: dim or None}, as `param_shardings` gives them; mesh.py:173)."""
    from avec_tpu_torch.parallel import tensor_parallel as tp

    return tp.shard_state(state, {k: d for k, d in shardings.items()
                                  if d is not None}, mesh.model)


def shard_like_params(state: Any, module: torch.nn.Module, mesh: Mesh,
                      optimizer: Optional[torch.optim.Optimizer] = None
                      ) -> Any:
    """A state saved whole -> this rank's shards, placed like `module`'s
    sharded parameters (mesh.py:177-208): with `optimizer`, its state_dict
    (each per-parameter tensor of its parameter's whole shape; step counters
    stay), else a {name: tensor} dict named like the module's state_dict
    (an EMA)."""
    from avec_tpu_torch.parallel import tensor_parallel as tp

    if optimizer is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        return tp.map_optimizer_state(
            state, params, lambda v, d: tp._own_slice(v, d, mesh.model),
            whole=True)
    return tp.shard_state(state, tp.sharded_names(module), mesh.model)
