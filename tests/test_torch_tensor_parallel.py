"""The port's tensor-parallel GPT (`Trainer(model_parallel=...,
param_sharding_rules=gpt_tensor_parallel_rules())`) vs the JAX package's
tensor-parallel run of tests/test_parallel.py.

GPT-Tiny (d 64, 2 blocks, 2 heads, vocab 64) on `_tiny_gpt_batch` (16
sequences of 16 tokens), the JAX model's initial weights carried over by
`params_from_jax`, dropout off on both sides, the cross-entropy with
ignore_index -1 and the optimizer named "Adam" in both packages'
`compile` (`optim_dict["Adam"](lr=0.001)`: every parameter moves by about
1e-3 a step, so the parameters after the steps test the update). The JAX
run is
`model_parallel=4` on the 8-device CPU mesh (data 2 x model 4); the port
runs 2 steps on 4 gloo ranks at model_parallel 4 (data 1: a head of 32
columns spans two ranks' query columns, so q, k, v are gathered before
attention) and at model_parallel 2 x data 2 (each rank attends over its
own head). Held: the losses of both steps within 2e-5 of the JAX run's;
the sharded parameters and each rank's shard shapes equal to JAX's
addressable shards (torch's (out, in) weights for JAX's (in, out)
kernels), each rank holding 1/mp of every sharded parameter; the gathered
parameters after the steps within 1e-5 of JAX's (the attention key biases,
whose gradient is analytically zero and whose Adam steps follow rounding
noise in both packages, within 1e-4 of where they started); the gradient
norm within
1e-5 relative of the one-rank port's; the AdamW decay mask of each
rank's sharded model equal to the one-rank model's. A checkpoint of the sharded run is
the file a one-rank run writes (keys and shapes, values and Adam moments
within 1e-5), and a sharded trainer that loads it holds the same shards. A
vocabulary that mp does not divide leaves the head replicated in both
packages.
"""

import jax
import numpy as np
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.parallel import mesh as pmesh
from avec_tpu.train.losses import SoftmaxCrossEntropy as JaxSCE
from avec_tpu_torch.convert import params_from_jax
from avec_tpu_torch.models.zoo import GPT
from avec_tpu_torch.parallel import dist as pdist
from avec_tpu_torch.parallel import tensor_parallel as tp
from avec_tpu_torch.train.checkpoint import load_checkpoint
from avec_tpu_torch.train.optim import gpt_decay_mask

from test_parallel import _tiny_gpt_batch
from test_torch_mesh import GPT_TINY, gpt_tp_rank, gpt_trainer

torch.set_num_threads(1)

STEPS = 2


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX run at model_parallel 4: initial params, losses, params after
    the steps, and each leaf's addressable shard shape (None where
    replicated)."""
    model = jzoo.GPT(**GPT_TINY)
    model.compile(losses=JaxSCE(ignore_index=-1), optimizer="Adam")
    model.mesh = pmesh.make_mesh(model_parallel=4)
    model.param_sharding_rules = pmesh.gpt_tensor_parallel_rules()
    batch = _tiny_gpt_batch()
    model.build(batch["inputs"])
    init = jax.tree.map(np.asarray, model.params)
    shard_shapes = {
        k: (None if v.sharding.is_fully_replicated
            else v.addressable_shards[0].data.shape)
        for k, v in _leaves(model.params)}
    step_fn = model._build_train_step(accumulated_steps=1,
                                      eval_training=False)
    gbatch = pmesh.host_local_batch_to_global(
        model.mesh, model._stack_micro(batch, 1), batch_axis=1)
    state, losses = model._state(), []
    for _ in range(STEPS):
        state, (ls, _, _) = step_fn(state, gbatch, jax.random.PRNGKey(0))
        losses.append(float(ls["loss"]))
    after = jax.tree.map(np.asarray, state["params"])
    state0 = {k: v.numpy() for k, v in params_from_jax(init).items()}
    return state0, losses, after, shard_shapes, batch


@pytest.mark.parametrize("mp", [4, 2])
def test_tensor_parallel_gpt_matches_jax(mp, jax_tp, tmp_path):
    state0, want_losses, want_after, shard_shapes, batch = jax_tp
    ckpt = str(tmp_path / "tp.ckpt")
    ranks = pdist.spawn(gpt_tp_rank, 4, "gloo", "cpu", state0, batch, mp,
                        STEPS, ckpt)
    assert ranks[0]["mesh"] == {"data": 4 // mp, "model": mp}

    # shardings: the same parameters, the same shard shapes as JAX at mp 4
    jax_sharded = {k for k, s in shard_shapes.items() if s is not None}
    port_names = {k for k in ranks[0]["shards"]}
    assert len(port_names) == len(jax_sharded) == 2 * 10 + 3
    for r in ranks:
        for n, (shape, whole) in r["shards"].items():
            assert int(np.prod(whole)) == mp * r["numel"][n], n
    if mp == 4:
        tree = {}
        for path, s in shard_shapes.items():
            node = tree
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.zeros(s, np.float32) if s else None
        want = {k: tuple(v.shape) for k, v in params_from_jax(
            _drop_none(tree)).items()}
        assert set(want) == port_names
        for r in ranks:
            assert {n: s for n, (s, _) in r["shards"].items()} == want

    # losses, gradient norms, gathered parameters
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-5,
                                   atol=2e-5)
        assert r["losses"] == ranks[0]["losses"]
    want_params = {k: v.numpy() for k, v in params_from_jax(
        want_after).items()}
    for r in ranks:
        assert r["params"].keys() == want_params.keys()
        for k, w in want_params.items():
            if k.endswith("key_layer.bias"):
                # analytically zero gradient (a shift of every score of a
                # row): both packages step on rounding noise
                for a in (r["params"][k], w):
                    assert np.abs(a - state0[k]).max() <= 1e-4, (mp, k)
                continue
            assert np.abs(w - state0[k]).max() > 1e-3, k         # it moved
            assert np.abs(r["params"][k] - w).max() <= 1e-5, (mp, k)
    one = gpt_trainer(state0, rules=False)
    # the AdamW decay mask sees the sharded Linear weights as Linear weights
    for r in ranks:
        assert r["decay_mask"] == gpt_decay_mask(one.model)
    norms = [float(one.train_step(batch)[1]["grad_norm"])
             for _ in range(STEPS)]
    np.testing.assert_allclose(ranks[0]["grad_norms"], norms, rtol=1e-5)

    # the checkpoint is the one-rank file; reloading restores the shards
    assert all(r["reloaded_equal"] for r in ranks)
    one_path = str(tmp_path / "one.ckpt")
    one.save(one_path)
    got, ref = load_checkpoint(ckpt), load_checkpoint(one_path)
    assert got["model_step"] == ref["model_step"] == STEPS
    assert got["model_state_dict"].keys() == ref["model_state_dict"].keys()
    for k, v in ref["model_state_dict"].items():
        g = got["model_state_dict"][k]
        assert g.shape == v.shape and float((g - v).abs().max()) <= 1e-5, k
    g_opt, r_opt = got["optimizer_state_dict"], ref["optimizer_state_dict"]
    assert g_opt["param_groups"] == r_opt["param_groups"]
    for i, entry in r_opt["state"].items():
        for key, v in entry.items():
            g = g_opt["state"][i][key]
            assert g.shape == v.shape, (i, key)
            assert float((g - v).abs().max()) <= 1e-5 * max(
                1.0, float(v.abs().max())), (i, key)


def _drop_none(tree):
    return {k: _drop_none(v) if isinstance(v, dict) else v
            for k, v in tree.items() if v is not None}


def test_an_indivisible_vocabulary_leaves_the_head_replicated():
    """Vocabulary 66 at mp 4: JAX replicates the head kernel and bias and
    shards the embedding on its 64 hidden columns; so does the port."""
    kw = dict(GPT_TINY, vocab_size=66)
    model = jzoo.GPT(**kw)
    shapes = jax.eval_shape(lambda: model.net.init(
        {"params": jax.random.PRNGKey(0)}, np.zeros((1, 16), np.int32),
        training=False))["params"]
    mesh = pmesh.make_mesh(model_parallel=4)
    specs = pmesh.param_shardings(mesh, shapes,
                                  pmesh.gpt_tensor_parallel_rules())
    jax_sharded = {k for k, s in _leaves(specs)
                   if not s.is_fully_replicated}
    assert "head/kernel" not in jax_sharded and "head/bias" not in jax_sharded
    assert "embedding/embedding" in jax_sharded
    port = tp.param_shardings(4, GPT(device="cpu", **kw),
                              tp.gpt_tensor_parallel_rules())
    assert port["head.weight"] is None and port["head.bias"] is None
    assert port["embedding.weight"] == 1
    assert sum(d is not None for d in port.values()) == len(jax_sharded)
