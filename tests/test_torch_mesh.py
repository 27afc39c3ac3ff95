"""The port's mesh, batch assembly and tensor-parallel layers
(`avec_tpu_torch.parallel.dist`, `parallel/tensor_parallel.py`) on gloo
ranks on the CPU, and the rank functions of the tests that hold them
against the JAX package (`test_torch_tensor_parallel.py`,
`test_torch_train_step_dp_zoo.py`).

This module imports neither JAX nor `avec_tpu`: `spawn` starts each rank as
a fresh interpreter that imports the module defining the rank function. One
spawn per test; each rank runs one torch thread.

  * `make_mesh` lays 4 ranks out as JAX's (data, model) grid, model axis
    fastest, and refuses a model_parallel that does not divide the world;
  * the four collectives of the sharded layers (copy-in, reduce-out,
    gather, scatter) have the forward and backward their docstrings state,
    exactly;
  * `host_local_batch_to_global` pads ragged rank-local batches to one
    shape with the collate's padding values (the sharded branch), and
    gathers the whole batch on every rank where the ranks' batch sizes
    differ (the gather branch); every rank takes the same branch;
  * a data-parallel step of the AO model on 2 ranks whose batches were
    collated apart (padded to different lengths) and assembled equals the
    one-process step on the global batch: losses 1e-5 relative, every
    gradient leaf 2e-3 of its largest entry plus 1e-7, BN statistics 1e-5
    (the fp32 tolerances of `chip_smoke.py` phase 16);
  * `Trainer.fit` on a last partial batch (ranks' sizes 2 and 1) takes
    the one-process step on the whole batch; a two-rank `evaluate` gives
    one process's losses on a set whose last batch is partial.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from avec_tpu_torch.parallel import dist as pdist
from avec_tpu_torch.parallel import tensor_parallel as tp

torch.set_num_threads(1)

SMALL_AO = dict(vocab_size=16, num_blocks=(1, 1, 1), interctc_blocks=(1,),
                att_type="patch")


# ---- rank functions: fn(device, *args) -> picklable result

def mesh_rank(device, model_parallel):
    """The mesh's groups as global ranks, and the four collectives on
    rank-dependent inputs: their outputs and the gradients they pass
    back."""
    torch.set_num_threads(1)
    mesh = pdist.make_mesh(model_parallel)
    ranks = lambda g: (None if g is None  # noqa: E731
                       else dist.get_process_group_ranks(g))
    r = dist.get_rank()
    g = mesh.model
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    outs = {}
    for name, fn in (("copy_in", lambda a: tp.copy_in(a, g)),
                     ("reduce_out", lambda a: tp.reduce_out(a, g)),
                     ("gather", lambda a: tp.gather(a, g)),
                     ("scatter", lambda a: tp.scatter(a, g))):
        x.grad = None
        y = fn(x) if name != "scatter" else fn(x.repeat(1, model_parallel))
        weight = torch.arange(float(y.numel())).reshape(y.shape) + r
        (y * weight).sum().backward()
        outs[name] = (y.detach().clone(), x.grad.clone())
    return {"rank": r, "shape": mesh.shape, "data_rank": mesh.data_rank,
            "model_rank": mesh.model_rank, "data": ranks(mesh.data),
            "model": ranks(mesh.model), "outs": outs}


def bad_mesh_rank(device):
    torch.set_num_threads(1)
    pdist.make_mesh(3)


def shard_layers_rank(device):
    """GPT-Tiny (2 heads) sharded at model_parallel 2: its parameter names
    before and after, the layers that hold shards, the attention's head
    count and the split flags; then the error of sharding a fused FFN."""
    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.models.zoo import GPT

    torch.set_num_threads(1)
    mesh = pdist.make_mesh(2)
    model = GPT(device="cpu", **GPT_TINY)
    before = [n for n, _ in model.named_parameters()]
    tp.shard_module(model, mesh, tp.gpt_tensor_parallel_rules())
    block = model.transformer.blocks[0]
    att = block.self_att_module.attention
    ff = block.ff_module.layers
    layers = {"q": att.query_layer, "out": att.output_layer,
              "ffn_in": ff["1"], "ffn_out": ff["4"], "head": model.head}
    out = {"before": before, "after": [n for n, _ in model.named_parameters()],
           "types": {k: type(v).__name__ for k, v in layers.items()},
           "split": {k: (v.split_in, v.split_out) for k, v in layers.items()},
           "embedding": type(model.embedding).__name__,
           "heads": att.num_heads}
    fused = FeedForwardModule(8, 16, fused_ffn=True)
    try:
        tp.shard_module(fused, mesh, [(r"layers\.1\.weight$", 0),
                                      (r"layers\.1\.bias$", 0)])
    except ValueError as e:
        out["fused_error"] = str(e)
    return out


def assemble_rank(device, batches, padding):
    """This rank's `batches[rank]` through `assemble_batch` over the data
    axis of a one-column mesh."""
    torch.set_num_threads(1)
    mesh = pdist.make_mesh(1)
    out, kept = pdist.assemble_batch(batches[dist.get_rank()], mesh, 0,
                                     padding)
    again = pdist.host_local_batch_to_global(batches[dist.get_rank()], mesh,
                                             padding=padding)
    return {"batch": out, "kept": kept, "again": again}


def _ao_trainer(state, data_parallel, device="cpu", reduction="mean",
                tokenizer=None):
    from avec_tpu_torch.models.zoo import AudioEfficientConformerInterCTC
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    model = AudioEfficientConformerInterCTC(device=device, fused_conv=True,
                                            fused_ffn=True, fused_att=True,
                                            **SMALL_AO)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    if tokenizer is not None:
        from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
        from avec_tpu_torch.train.metrics import WordErrorRate

        wer = dict(metrics={"outputs": WordErrorRate()},
                   decoders={"outputs": CTCGreedySearchDecoder(tokenizer)})
    else:
        wer = {}
    tr = Trainer(model=model, device=device, precision="float32",
                 loss=CTCLoss(zero_infinity=True, reduction=reduction),
                 loss_weights=[0.5, 0.5], data_parallel=data_parallel, **wer)
    tr.model.set_regularization(False)
    return tr


def ragged_dp_rank(device, parts):
    """The AO data-parallel step on this rank's own collated batch,
    assembled by `host_local_batch_to_global`: the global losses,
    gradients and BN statistics (rank 0's), the assembled shapes."""
    torch.set_num_threads(1)
    tr = _ao_trainer(None, True)
    batch = pdist.host_local_batch_to_global(parts[dist.get_rank()],
                                             tr.mesh)
    losses, grads = tr.loss_and_grads(batch)
    return {"shapes": [a.shape for a in batch["inputs"]],
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: g.numpy() for n, g in grads.items()},
            "stats": {n: b.numpy().copy()
                      for n, b in tr.model.named_buffers()
                      if "running_" in n}}


class _Loader:
    """A loader of the given batches (what `Trainer.fit` reads)."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        del epoch

    def __iter__(self):
        return iter(self.batches)


def partial_fit_rank(device, parts):
    """`Trainer.fit` for one step on this rank's part of a last partial
    batch (ranks' batch sizes differ: the gather branch), returning the
    epoch's loss and Adam's first moments by parameter name."""
    torch.set_num_threads(1)
    tr = _ao_trainer(None, True, reduction="sum")
    history = tr.fit(_Loader([parts[dist.get_rank()]]), 1,
                     eval_period_epoch=None, saving_period_epoch=None,
                     eval_training=False)
    state = tr.optimizer.optimizer.state
    return {"loss": history[0]["losses"]["loss"],
            "exp_avg": {n: state[p]["exp_avg"].numpy()
                        for n, p in tr.model.named_parameters()}}


def evaluate_rank(device, batches, tokenizer):
    """A data-parallel trainer's `evaluate` (losses, greedy WER) over the
    whole set on every rank."""
    torch.set_num_threads(1)
    tr = _ao_trainer(None, True, tokenizer=tokenizer)
    return tr.evaluate(batches)


GPT_TINY = dict(vocab_size=64, model="GPT-Tiny", max_pos_encoding=32,
                drop_rate=0.0)


def gpt_trainer(state, model_parallel=1, data_parallel=False, rules=True,
                optimizer="Adam"):
    """GPT-Tiny from `state` (numpy), dropout off, the cross-entropy of
    tests/test_parallel.py (ignore_index -1) and the optimizer named "Adam"
    (lr 0.001; None: the GPT's AdamW recipe, two parameter groups), on
    `model_parallel` ranks with `gpt_tensor_parallel_rules()`."""
    from avec_tpu_torch.models.zoo import GPT
    from avec_tpu_torch.train.losses import SoftmaxCrossEntropy
    from avec_tpu_torch.train.model import Trainer

    model = GPT(device="cpu", **GPT_TINY)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return Trainer(model=model, device="cpu", precision="float32",
                   loss=SoftmaxCrossEntropy(ignore_index=-1), metrics=None,
                   optimizer=optimizer,
                   model_parallel=model_parallel,
                   data_parallel=data_parallel,
                   param_sharding_rules=(tp.gpt_tensor_parallel_rules()
                                         if rules else None))


def gpt_tp_rank(device, state, batch, model_parallel, steps, ckpt):
    """`steps` train steps of the sharded GPT on this rank's data slice:
    the losses and gradient norms, the shard shapes and whole shapes, the
    parameters gathered after the steps, the checkpoint written through
    `save` (rank 0), and whether a fresh sharded trainer that loads it holds
    the same shards and Adam moments (and so after one AdamW step); and
    the GPT's AdamW decay mask of the sharded model."""
    from avec_tpu_torch.train.optim import gpt_decay_mask

    torch.set_num_threads(1)
    world = dist.get_world_size()
    tr = gpt_trainer(state, model_parallel, world > model_parallel)
    decay = gpt_decay_mask(tr.model)
    params = dict(tr.model.named_parameters())
    shards = {n: (tuple(p.shape), p.tp_shape) for n, p in params.items()
              if tp.tp_dim(p) is not None}
    part = pdist.shard_batch(batch, tr.mesh)
    losses, norms = [], []
    for _ in range(steps):
        got, infos = tr.train_step(part)
        losses.append(float(got["loss"]))
        norms.append(float(infos["grad_norm"]))
    whole = tp.gather_state({n: p.detach() for n, p in params.items()},
                            tp.sharded_names(tr.model), tr.mesh.model)
    tr.save(ckpt)
    dist.barrier()
    moments = lambda t: [s["exp_avg"] for s in  # noqa: E731
                         t.optimizer.optimizer.state_dict()["state"].values()]
    same = True
    for opt, path in (("Adam", ckpt), (None, ckpt + ".adamw")):
        if opt is None:           # AdamW: moments in its two groups' order
            tr = gpt_trainer(state, model_parallel, world > model_parallel,
                             optimizer=None)
            tr.train_step(part)
            tr.save(path)
            dist.barrier()
        again = gpt_trainer(state, model_parallel, world > model_parallel,
                            optimizer=opt)
        again.load(path)
        same = same and (all(torch.equal(p, q) for p, q in zip(
            tr.model.parameters(), again.model.parameters()))
            and all(torch.equal(a, b) for a, b in zip(moments(tr),
                                                       moments(again)))
            and again.step == tr.step)
    return {"rank": dist.get_rank(), "mesh": tr.mesh.shape,
            "losses": losses, "grad_norms": norms, "shards": shards,
            "numel": {n: p.numel() for n, p in params.items()},
            "params": {n: v.numpy() for n, v in whole.items()},
            "reloaded_equal": same, "decay_mask": decay}


# the zoo models of the data-parallel tests at small depths (the AO-Tone
# config's audio depths, AV-Tone's video depths, LRW at blocks (1, 1))
ZOO_DP = {
    "ao": ("AudioEfficientConformerInterCTC",
           dict(vocab_size=16, att_type="patch", num_blocks=(2, 2, 1),
                interctc_blocks=(2, 4))),
    "ao_causal": ("AudioEfficientConformerInterCTC",
                  dict(vocab_size=16, att_type="patch", num_blocks=(2, 2, 1),
                       interctc_blocks=(2, 4), causal=True, left_context=64)),
    "vo": ("VisualEfficientConformerInterCTC",
           dict(vocab_size=16, num_blocks=(2, 1), interctc_blocks=(2,))),
    "lrw": ("VisualEfficientConformerCE",
            dict(vocab_size=20, num_blocks=(1, 1))),
}
ZOO_ROUTE = dict(fused_att=True, fused_conv=True, fused_ffn=True)


def zoo_trainer(kind, state, data_parallel, weights=None):
    """A `ZOO_DP` model on the fused routes (stem "2d" for video) from
    `state`, fp32, CTC (zero_infinity) with `weights` for the CTC models,
    the LRW classifier's own cross-entropy."""
    from avec_tpu_torch.models import zoo
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    name, kwargs = ZOO_DP[kind]
    extra = {} if kind.startswith("ao") else {"stem_mode": "2d"}
    model = getattr(zoo, name)(device="cpu", **kwargs, **ZOO_ROUTE, **extra)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    loss = None if kind == "lrw" else CTCLoss(zero_infinity=True)
    return Trainer(model=model, device="cpu", precision="float32", loss=loss,
                   loss_weights=weights, data_parallel=data_parallel)


def zoo_dp_rank(device, kind, state, batch, weights):
    """The data-parallel step of a zoo model on this rank's `shard_batch`
    slice, dropout and SpecAugment off: the global losses, a digest of the
    gradients, and rank 0's gradients and BN statistics; the launches per
    step; then 2 steps with dropout and SpecAugment on and a digest of the
    parameters."""
    import hashlib

    torch.set_num_threads(1)

    def digest(tensors):
        h = hashlib.sha256()
        for a in tensors:
            h.update(a.detach().contiguous().numpy().tobytes())
        return h.hexdigest()

    part = pdist.shard_batch(batch)
    tr = zoo_trainer(kind, state, True, weights)
    tr.model.set_regularization(False)
    losses, grads = tr.loss_and_grads(part)
    rank0 = dist.get_rank() == 0
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "grads_digest": digest(grads.values()),
           "grads": ({n: g.numpy() for n, g in grads.items()} if rank0
                     else None),
           "buffers": {n: b.numpy().copy()
                       for n, b in tr.model.named_buffers()},
           "launches_per_step": tr.model.kernel_launches_per_step()}
    tr = zoo_trainer(kind, state, True, weights)
    for _ in range(2):
        tr.train_step(part)
    out["params_digest"] = digest(tr.model.parameters())
    out["moved"] = sum(not np.array_equal(p.detach().numpy(), state[n])
                       for n, p in tr.model.named_parameters())
    return out


# ---- tests

def test_make_mesh_lays_ranks_out_as_the_jax_grid():
    results = pdist.spawn(mesh_rank, 4, "gloo", "cpu", 2)
    for res in results:
        r = res["rank"]
        assert res["shape"] == {"data": 2, "model": 2}
        assert (res["data_rank"], res["model_rank"]) == (r // 2, r % 2)
        assert res["model"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert res["data"] == [r % 2, r % 2 + 2]
        mr = r % 2
        y, gx = res["outs"]["copy_in"]
        assert torch.equal(y, torch.full((2, 3), float(r + 1)))
        # the cotangent summed over the model group: weight + r, summed
        want = sum(torch.arange(6.0).reshape(2, 3) + q
                   for q in res["model"])
        assert torch.equal(gx, want)
        y, gx = res["outs"]["reduce_out"]
        assert torch.equal(y, torch.full((2, 3), float(sum(
            q + 1 for q in res["model"]))))
        assert torch.equal(gx, torch.arange(6.0).reshape(2, 3) + r)
        y, gx = res["outs"]["gather"]
        assert torch.equal(y, torch.cat([torch.full((2, 3), float(q + 1))
                                         for q in res["model"]], dim=1))
        full = torch.arange(12.0).reshape(2, 6) + r
        assert torch.equal(gx, full[:, 3 * mr:3 * mr + 3])
        y, gx = res["outs"]["scatter"]
        assert torch.equal(y, torch.full((2, 3), float(r + 1)))
        # the slices' cotangents gathered, then summed over the repeat
        got = torch.cat([torch.arange(6.0).reshape(2, 3) + q
                         for q in res["model"]], dim=1)
        assert torch.equal(gx, got[:, :3] + got[:, 3:])
    with pytest.raises(ValueError, match="does not divide"):
        pdist.spawn(bad_mesh_rank, 2, "gloo", "cpu")


def test_shard_module_swaps_in_parallel_layers_under_the_same_names():
    """The sharded GPT keeps its parameter names and forwards: its sharded
    Linear / Embedding layers become ParallelLinear / ParallelEmbedding,
    q / k / v and FFN-in keep their columns into the row-parallel output
    layer and FFN-out (2 heads over 2 ranks: one local head), the head
    gathers its vocabulary columns; a fused FFN, whose kernel takes whole
    weights, is refused."""
    for res in pdist.spawn(shard_layers_rank, 2, "gloo", "cpu"):
        assert res["after"] == res["before"]
        assert set(res["types"].values()) == {"ParallelLinear"}
        assert res["embedding"] == "ParallelEmbedding"
        assert res["heads"] == 1
        assert res["split"] == {"q": (True, True), "out": (True, True),
                                "ffn_in": (True, True),
                                "ffn_out": (True, True),
                                "head": (False, False)}
        assert "fused kernels take whole weights" in res["fused_error"]


def _ragged_parts():
    """Two ranks' collated batches: 2 utterances each, rank 0's padded to
    1.1 s, rank 1's to 0.7 s, labels padded to 5 and 3 with -1."""
    rng = np.random.RandomState(5)
    parts = []
    for alen, ulen in (([17600, 12800], [5, 2]), ([8000, 11200], [3, 3])):
        alen = np.asarray(alen, np.int32)
        audio = np.zeros((2, alen.max()), np.float32)
        for i, n in enumerate(alen):
            audio[i, :n] = rng.randn(n) * 0.1
        labels = np.full((2, max(ulen)), -1, np.int32)
        for i, n in enumerate(ulen):
            labels[i, :n] = rng.randint(1, 16, size=n)
        parts.append({"inputs": [audio, alen],
                      "targets": (labels, np.asarray(ulen, np.int32))})
    return parts


def _concat(parts, pad=(0, 0, -1, 0)):
    """The one-process global batch: the parts padded to the longest and
    stacked, rank 0's rows first."""
    leaves = [p["inputs"] + list(p["targets"]) for p in parts]
    out = []
    for i, value in enumerate(pad):
        arrs = [lv[i] for lv in leaves]
        width = max(a.shape[1] for a in arrs) if arrs[0].ndim > 1 else None
        if width is not None:
            arrs = [np.pad(a, ((0, 0), (0, width - a.shape[1])),
                           constant_values=value) for a in arrs]
        out.append(np.concatenate(arrs))
    return {"inputs": out[:2], "targets": tuple(out[2:])}


def test_host_local_batch_to_global_both_branches():
    parts = _ragged_parts()
    padding = {"inputs": [0, 0], "targets": (-1, 0)}
    results = pdist.spawn(assemble_rank, 2, "gloo", "cpu", parts, padding)
    whole = _concat(parts)
    for r, res in enumerate(results):
        assert res["kept"] is True
        got = res["batch"]
        want_audio = whole["inputs"][0][2 * r:2 * r + 2]
        np.testing.assert_array_equal(got["inputs"][0], want_audio)
        np.testing.assert_array_equal(got["targets"][0],
                                      whole["targets"][0][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["inputs"][1], parts[r]["inputs"][1])
        assert isinstance(got["targets"], tuple)
        np.testing.assert_array_equal(res["again"]["inputs"][0], want_audio)
    # a last partial batch: 2 rows on rank 0, 1 on rank 1 -> every rank
    # holds the whole batch of 3
    partial = [parts[0], {"inputs": [a[:1] for a in parts[1]["inputs"]],
                          "targets": tuple(a[:1]
                                           for a in parts[1]["targets"])}]
    results = pdist.spawn(assemble_rank, 2, "gloo", "cpu", partial, padding)
    whole = _concat(partial)
    for res in results:
        assert res["kept"] is False
        for got, want in zip(res["batch"]["inputs"]
                             + list(res["batch"]["targets"]),
                             whole["inputs"] + list(whole["targets"])):
            np.testing.assert_array_equal(got, want)


def test_single_process_assembly_is_the_identity():
    batch = _ragged_parts()[0]
    out, kept = pdist.assemble_batch(batch)
    assert kept and out is batch
    mesh = pdist.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model is None
    assert pdist.shard_batch(batch, mesh) is batch


def _max_rel(a, b):
    return float(np.abs(a - b).max())


def test_ragged_dp_step_equals_the_one_process_step():
    """Each rank's batch collated apart (padded to 1.1 s and 0.7 s), then
    assembled: the two-rank step against one process on the global
    batch."""
    parts = _ragged_parts()
    ranks = pdist.spawn(ragged_dp_rank, 2, "gloo", "cpu", parts)
    whole = _concat(parts)
    assert ranks[0]["shapes"] == ranks[1]["shapes"] == [
        (2, whole["inputs"][0].shape[1]), (2,)]
    tr = _ao_trainer(None, False)
    losses, grads = tr.loss_and_grads(whole)
    got = ranks[0]
    assert got["losses"] == ranks[1]["losses"]
    assert set(got["losses"]) == set(losses)
    for k, v in losses.items():
        assert got["losses"][k] == pytest.approx(float(v), rel=1e-5), k
    for n, g in grads.items():
        w = g.numpy()
        assert _max_rel(got["grads"][n], w) <= 2e-3 * np.abs(w).max() + 1e-7, n
    for n, b in tr.model.named_buffers():
        if "running_" in n:
            np.testing.assert_allclose(got["stats"][n], b.numpy(), rtol=0,
                                       atol=1e-5, err_msg=n)


def test_fit_on_a_partial_batch_takes_the_whole_batch_step():
    """Ranks whose batches differ in size (2 rows and 1): `fit` assembles
    the whole batch on both (the gather branch) and weighs each rank's
    share 1 / world, also under the "sum" reduction (whose shards would
    weigh 1), so the step is the one-process step on the 3 rows:
    the loss 1e-5 relative, Adam's first moment (0.1 g) of every parameter
    within 2e-3 of its leaf's largest entry plus 1e-7."""
    parts = _ragged_parts()
    last = {"inputs": [a[:1] for a in parts[1]["inputs"]],
            "targets": tuple(a[:1] for a in parts[1]["targets"])}
    ranks = pdist.spawn(partial_fit_rank, 2, "gloo", "cpu", [parts[0], last])
    tr = _ao_trainer(None, False, reduction="sum")
    losses, _ = tr.train_step(_concat([parts[0], last]))
    state = tr.optimizer.optimizer.state
    for got in ranks:
        assert got["loss"] == pytest.approx(float(losses["loss"]), rel=1e-5)
        for n, p in tr.model.named_parameters():
            w = state[p]["exp_avg"].numpy()
            err = np.abs(got["exp_avg"][n] - w).max()
            assert err <= 2e-3 * np.abs(w).max() + 1e-7, (n, err)


def test_two_rank_evaluate_with_a_partial_last_batch(tmp_path):
    """Every rank evaluates the whole set: the losses and the greedy WER of
    one process, a last batch of one utterance included."""
    from avec_tpu_torch.utils.tokenizer import Tokenizer, train_bpe

    tok = str(tmp_path / "tok.json")
    Tokenizer(train_bpe(["abc abd bcd cab dab"] * 4, 16)).save(tok)
    parts = _ragged_parts()
    for p in parts:          # labels the tokenizer decodes (no -1 padding)
        p["targets"] = (np.maximum(p["targets"][0], 0), p["targets"][1])
    last = {"inputs": [a[:1] for a in parts[1]["inputs"]],
            "targets": tuple(a[:1] for a in parts[1]["targets"])}
    batches = [parts[0], last]
    ranks = pdist.spawn(evaluate_rank, 2, "gloo", "cpu", batches, tok)
    want = _ao_trainer(None, False, tokenizer=tok).evaluate(batches)
    assert "wer" in want[1]
    for got in ranks:
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k, v in w.items():
                assert g[k] == pytest.approx(v, rel=1e-6), k
