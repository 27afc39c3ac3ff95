"""The port's process-group layer (`avec_tpu_torch.parallel.dist`) on gloo
ranks on the CPU, and the rank functions of the port's data-parallel tests.

This module imports neither JAX nor `avec_tpu`: `spawn` starts each rank as
a fresh interpreter that imports the module defining the rank function, so
every function a rank runs lives here, and the tests that compare against
the JAX package (`test_torch_sync_bn.py`, `test_torch_conv_module_dp.py`,
`test_torch_train_step_dp.py`) import them from here. One spawn per test;
each rank runs one torch thread.
"""

import hashlib
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from avec_tpu_torch.parallel import dist as pdist

torch.set_num_threads(1)


# ---- rank functions: fn(device, *args) -> picklable result

def _shard(a):
    """This rank's equal slice of a global numpy batch axis, as a tensor."""
    r, w = dist.get_rank(), dist.get_world_size()
    n = a.shape[0] // w
    return torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n]))


def collectives_rank(device, batch):
    torch.set_num_threads(1)
    r, w = pdist.rank(), pdist.world_size()
    gathered = pdist.process_allgather(["rank"] * (r + 1))
    sent = {"root": r, "payload": list(range(w))} if r == w - 1 else None
    got = pdist.broadcast_host_object(sent, root=w - 1)
    if r == 0:
        time.sleep(1.0)
    t0 = time.monotonic()
    pdist.sync_global_devices("after-sleep")
    return {"rank": r, "world": w, "device": str(device),
            "shard": pdist.shard_batch(batch), "gathered": gathered,
            "broadcast": got, "waited_s": time.monotonic() - t0}


def failing_rank(device, bad_rank, how):
    torch.set_num_threads(1)
    if dist.get_rank() == bad_rank:
        if how == "raise":
            raise ValueError(f"boom on rank {bad_rank}")
        os._exit(3)
    dist.barrier()              # the healthy ranks wait here until stopped
    return "unreachable"


def module_dp_rank(device, name, x, g, params, kwargs, dtype="float32"):
    """One rank of a fused module's DP form on its shard of x (and of the
    cotangent g, and of `lengths` where given), on `device` with x in
    `dtype`: (outputs, [dx] + parameter gradients, launch counts), numpy in
    fp32; the gradients are this rank's partial sums."""
    torch.set_num_threads(1)
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.attention_module import (
        fused_attention_module_3d_dp)
    from avec_tpu_torch.ops.conv_module import fused_conv_module_3d_dp
    from avec_tpu_torch.ops.ffn import fused_ffn_3d_dp

    fn = {"conv": fused_conv_module_3d_dp, "ffn": fused_ffn_3d_dp,
          "att": fused_attention_module_3d_dp}[name]
    dt = getattr(torch, dtype)
    kwargs = dict(kwargs)
    if kwargs.get("lengths") is not None:
        kwargs["lengths"] = _shard(np.asarray(kwargs["lengths"])).to(device)
    xt = _shard(x).to(device, dt).requires_grad_(True)
    leaves = [torch.from_numpy(p.copy()).to(device).requires_grad_(True)
              for p in params]
    _cuda.reset_launches()
    out = fn(xt, *leaves, deterministic=False, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    outs[0].backward(_shard(g).to(device, dt))
    return ([a.detach().float().cpu().numpy() for a in outs],
            [a.grad.float().cpu().numpy() for a in [xt] + leaves],
            dict(_cuda.launches))


def batchnorm_rank(device, x, g, state):
    """Sync BatchNorm in training mode on this rank's shard of a
    channels-first x: (y, dx, d weight, d bias, running mean, running
    var)."""
    torch.set_num_threads(1)
    from avec_tpu_torch.ops.layers import BatchNorm

    bn = BatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    bn.process_group = dist.group.WORLD
    bn.train()
    xt = _shard(x).requires_grad_(True)
    y = bn(xt)
    y.backward(_shard(g))
    return [a.detach().numpy() for a in (y, xt.grad, bn.weight.grad,
                                         bn.bias.grad, bn.running_mean,
                                         bn.running_var)]


def conv_module_rank(device, x, state, dims):
    """A ConvolutionModule (fused_conv on: K3dp at stride 1, the unfused
    layers with sync-BN at stride 2) in data-parallel training mode on this
    rank's shard: (y, buffers by name)."""
    torch.set_num_threads(1)
    from avec_tpu_torch.models.conformer import ConvolutionModule

    d, e, stride, k = dims
    mod = ConvolutionModule(d, e, stride, k, "same", 0.0, fused_conv=True)
    mod.load_state_dict({k_: torch.from_numpy(v) for k_, v in state.items()})
    for m in mod.modules():
        if hasattr(m, "process_group"):
            m.process_group = dist.group.WORLD
    mod.train()
    y = mod(_shard(x))
    return y.detach().numpy(), {n: b.numpy() for n, b in mod.named_buffers()}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _trainer(state, model_kwargs, weights, reduction, data_parallel):
    from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    model = AudioVisualEfficientConformerInterCTC(device="cpu", **model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return Trainer(model=model, device="cpu", precision="float32",
                   loss=CTCLoss(zero_infinity=True, reduction=reduction),
                   loss_weights=weights, data_parallel=data_parallel)


def train_step_dp_rank(device, state, model_kwargs, weights, batch,
                       reductions, steps):
    """The data-parallel step on this rank's shard of `batch`: for each
    reduction, the global losses, gradients and BN buffers after one forward
    + backward with dropout and SpecAugment off (the gradients from rank 0
    only, a digest of them from every rank); then `steps` full steps with
    dropout and SpecAugment on and a digest of the parameters."""
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank()}
    shard = pdist.shard_batch(batch)
    for red in reductions:
        tr = _trainer(state, model_kwargs, weights, red, True)
        tr.model.set_regularization(False)
        losses, grads = tr.loss_and_grads(shard)
        out[red] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "grads_digest": _digest(grads.values()),
            "buffers": {n: b.numpy() for n, b in tr.model.named_buffers()},
            "grads": ({n: g.numpy() for n, g in grads.items()}
                      if dist.get_rank() == 0 else None)}
    tr = _trainer(state, model_kwargs, weights, reductions[0], True)
    out["launches_per_step"] = tr.model.kernel_launches_per_step()
    for _ in range(steps):
        tr.train_step(shard)
    out["params_digest"] = _digest(tr.model.parameters())
    out["moved"] = sum(not np.array_equal(p.detach().numpy(), state[n])
                       for n, p in tr.model.named_parameters())
    return out


def dp_equals_plain_rank(device, state, model_kwargs, weights, batch):
    """At world size 1 the data-parallel step against the plain one, dropout
    off: the largest absolute difference of the losses, the gradients and
    the buffers (all expected to be exactly 0)."""
    torch.set_num_threads(1)
    runs = []
    for dp in (True, False):
        tr = _trainer(state, model_kwargs, weights, "mean", dp)
        tr.model.set_regularization(False)
        losses, grads = tr.loss_and_grads(batch)
        runs.append((losses, grads, dict(tr.model.named_buffers())))
    (l1, g1, b1), (l2, g2, b2) = runs
    diff = lambda a, b: max(float((a[k] - b[k]).abs().max()) for k in a)
    return {"losses": diff(l1, l2), "grads": diff(g1, g2),
            "buffers": diff(b1, b2), "keys_equal": (set(l1) == set(l2)
                                                    and set(g1) == set(g2))}


def pallas_stem_dp_rank(device, model_kwargs):
    """A data-parallel trainer over a "pallas" video stem (raises)."""
    torch.set_num_threads(1)
    from avec_tpu_torch.train.model import Trainer

    Trainer(device="cpu", precision="float32", data_parallel=True,
            stem_mode="pallas", **model_kwargs)
    return "constructed"


def specaugment_rank(device, model_kwargs, draws):
    """The SpecAugment of a data-parallel AV model on this rank, training
    mode: the entries its keep masks drop in `draws` calls on one set of
    lengths, (draws, 3, 80, 120) booleans."""
    torch.set_num_threads(1)
    from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC

    model = AudioVisualEfficientConformerInterCTC(device="cpu", **model_kwargs)
    model.set_data_parallel()
    model.set_generators(7)
    aug = model.encoder.audio_encoder.spec_augment.train()
    lengths = torch.tensor([120, 90, 60])
    return np.stack([(~aug.keep_mask(3, 80, 120, lengths)).numpy()
                     for _ in range(draws)])


# ---- tests of the process-group layer

def _host_batch():
    """A batch with leaves of 12 rows (split at 2 and 4 ranks), 6 rows
    (split at 2, whole at 4), 5 rows (whole at both), a 0-d array, a tensor
    and a Python int."""
    rng = np.random.RandomState(0)
    return {"inputs": [rng.randn(12, 3).astype(np.float32),
                       np.arange(6, dtype=np.int32),
                       np.arange(5, dtype=np.int32), np.float32(2.5)],
            "targets": (torch.arange(24).reshape(12, 2), 7)}


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_and_host_collectives(world):
    batch = _host_batch()
    results = pdist.spawn(collectives_rank, world, "gloo", "cpu", batch)
    assert [r["rank"] for r in results] == list(range(world))
    for res in results:
        r, n = res["rank"], 12 // world
        shard = res["shard"]
        assert res["world"] == world and res["device"] == "cpu"
        assert isinstance(shard, dict) and isinstance(shard["inputs"], list)
        assert isinstance(shard["targets"], tuple)
        np.testing.assert_array_equal(shard["inputs"][0],
                                      batch["inputs"][0][r * n:(r + 1) * n])
        six = batch["inputs"][1]
        want6 = six[3 * r:3 * r + 3] if world == 2 else six
        np.testing.assert_array_equal(shard["inputs"][1], want6)
        np.testing.assert_array_equal(shard["inputs"][2], batch["inputs"][2])
        assert shard["inputs"][3] == np.float32(2.5)
        assert torch.equal(shard["targets"][0],
                           batch["targets"][0][r * n:(r + 1) * n])
        assert shard["targets"][1] == 7
        assert res["gathered"] == [["rank"] * (i + 1) for i in range(world)]
        assert res["broadcast"] == {"root": world - 1,
                                    "payload": list(range(world))}
        if r:                          # rank 0 slept 1 s before the barrier
            assert res["waited_s"] > 0.5, res


def test_single_process_defaults():
    """Without a process group: rank 0 of 1, the batch whole, the host
    collectives the identity."""
    assert not dist.is_initialized()
    batch = _host_batch()
    assert pdist.rank() == 0 and pdist.world_size() == 1
    shard = pdist.shard_batch(batch)
    assert shard["inputs"][0] is batch["inputs"][0]
    assert pdist.process_allgather("x") == ["x"]
    assert pdist.broadcast_host_object({"a": 1}) == {"a": 1}
    pdist.sync_global_devices()


def test_spawn_reraises_the_failing_rank_error():
    """A rank's exception reaches the caller with its traceback as a note,
    and the healthy rank blocked in a collective is stopped."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="boom on rank 1") as info:
        pdist.spawn(failing_rank, 2, "gloo", "cpu", 1, "raise", timeout=120)
    assert any("raised on rank 1 of 2" in note
               for note in getattr(info.value, "__notes__", []))
    assert time.monotonic() - t0 < 100


def test_spawn_reports_a_rank_that_dies():
    with pytest.raises(RuntimeError, match="rank 2 exited with code 3"):
        pdist.spawn(failing_rank, 3, "gloo", "cpu", 2, "exit", timeout=120)


def test_backend_is_named_explicitly():
    with pytest.raises(ValueError, match="backend"):
        pdist.init_distributed("mpi", 1, 0, "file:///nonexistent")
    with pytest.raises(ValueError, match="backend"):
        pdist.spawn(collectives_rank, 2, "auto", "cpu", {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            pdist.init_distributed("nccl", 1, 0, "file:///nonexistent")


def test_specaugment_bands_agree_across_ranks():
    """Data-parallel training draws one set of frequency bands for the
    global batch (the JAX step draws them once from one key): every rank
    masks the same bands in every draw, while each rank draws its own time
    masks."""
    small = dict(vocab_size=32, v_num_blocks=[1, 1], a_num_blocks=[1, 1, 1],
                 f_num_blocks=1, v_interctc_blocks=[1], a_interctc_blocks=[1],
                 f_interctc_blocks=[1])
    masks = pdist.spawn(specaugment_rank, 2, "gloo", "cpu", small, 6)
    bands = [m.all(axis=3) for m in masks]     # rows dropped at every frame
    assert bands[0].any() and np.array_equal(bands[0], bands[1])
    assert np.array_equal(bands[0], bands[0][:, :1].repeat(3, axis=1))
    assert len({b.tobytes() for b in bands[0]}) > 1    # new bands each draw
    assert not np.array_equal(masks[0], masks[1])      # time masks per rank
