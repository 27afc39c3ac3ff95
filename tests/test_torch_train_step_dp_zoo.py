"""The data-parallel train step of the audio-only (patch attention, and
causal with pad_lo 14), video-only and LRW models on 2 gloo ranks on the
CPU vs the JAX step on the global batch.

Depths: the AO-Tone config's audio encoder (blocks (2, 2, 1), InterCTC after
blocks 2 and 4, patch attention in stage 1; the causal model with left
context 64), AV-Tone's video encoder (blocks (2, 1), InterCTC after block
2) for the VO model, blocks (1, 1) for the LRW classifier; vocab 16 (LRW
20); global batches of 4 utterances of unequal lengths, 2 per rank
(`shard_batch` of the padded global batch), fp32. The port runs the fused
attention, convolution (K3dp plain stages) and FFN routes and the video
stem "2d" in their data-parallel forms with sync-BN through the ResNet
trunk, and all-reduces the rank-weighted gradients (the LRW
cross-entropy's mean weighted 1/2 a rank); the JAX step runs the whole
batch on one device through its default (unfused) layers, with dropout and
SpecAugment replaced by the identity for the duration (nothing in
`avec_tpu/` changes) and off on the port's side. The JAX VO and LRW nets
build their encoder at the reference depth; for the duration of a test the
encoder class their module looks up is given the small depth.

The LRW reference is the JAX step in float64 (`jax.enable_x64`, the
parameters and clips cast, and the float32 upcasts of
`avec_tpu.ops.layers` and `avec_tpu.train.losses` taken to float64 for the
duration). On this batch the JAX package's own fp32 gradient of the
ResNet's layer-4 convolutions lies 0.16 of the leaf's largest entry from
that float64 step (its BatchNorm backward through one-pass fp32
statistics over 20 clips x 3 x 3 positions), where the port's fp32
gradient lies within 0.065 of it, and the two float64 steps agree within
0.01.

Tolerances, those of tests/test_torch_train_step_dp.py: losses 1e-4
relative; every gradient leaf 2e-3 of its largest entry plus 1e-7 (the
video front end 0.15); updated BN statistics 1e-5. Both ranks hold the same
losses and gradients, launch the kernels `kernel_launches_per_step` counts
under their DP names, and after 2 steps with dropout and SpecAugment on
(each rank drawing its own masks) hold bit-identical parameters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import encoders as jenc
from avec_tpu.models import zoo as jzoo
from avec_tpu.train import losses as jlosses
from avec_tpu_torch.convert import params_from_jax, state_to_jax
from avec_tpu_torch.parallel.dist import spawn

from test_torch_mesh import ZOO_DP, zoo_dp_rank
from test_torch_support import random_variables
from test_torch_train_step import _leaves, no_jax_noise  # noqa: F401

torch.set_num_threads(1)

CONV_DP = [f"fused_conv_dp_{p}" for p in ("stats", "fwd", "bwd1", "bwd2")]


def _audio_batch(seed=3):
    """4 utterances of 1.2, 0.7, 1.0 and 0.5 s, noise past each length (so
    the fbank of the padding is not bimodal), 5/3/4/2 labels."""
    rng = np.random.RandomState(seed)
    alen = np.array([19200, 11200, 16000, 8000], np.int32)
    audio = (rng.randn(4, int(alen.max())) * 0.1).astype(np.float32)
    labels = rng.randint(1, 16, size=(4, 5)).astype(np.int32)
    return {"inputs": [audio, alen],
            "targets": (labels, np.array([5, 3, 4, 2], np.int32))}


def _video(frames, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(4, frames, 88, 88, 1) * rng.rand(4, frames, 1, 1, 1)
            * 2).astype(np.float32)


def _setup(kind):
    """(JAX model, global batch, loss weights by sorted output name, the
    JAX loss)."""
    name, kwargs = ZOO_DP[kind]
    ctc = jlosses.CTCLoss(zero_infinity=True, assert_shorter=False)
    if kind.startswith("ao"):
        return (getattr(jzoo, name)(**kwargs), _audio_batch(),
                [0.25, 0.25, 0.5], ctc)
    if kind == "vo":
        video = _video(6, 7)
        batch = {"inputs": [video, np.array([6, 4, 5, 3], np.int32)],
                 "targets": (np.random.RandomState(8).randint(
                     1, 16, size=(4, 3)).astype(np.int32),
                     np.array([3, 2, 3, 1], np.int32))}
        jmodel = jzoo.VisualEfficientConformerInterCTC(
            vocab_size=16, interctc_blocks=(2,))
        return jmodel, batch, [0.5, 0.5], ctc
    batch = {"inputs": _video(5, 11),
             "targets": np.array([3, 7, 19, 0], np.int32)}
    return (jzoo.VisualEfficientConformerCE(vocab_size=20), batch, None,
            jlosses.SoftmaxCrossEntropy())


class _Float64:
    """`jax.numpy` with float32 read as float64: the JAX layers' fp32
    upcasts (BatchNorm and LayerNorm statistics, the losses) in float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_step64(jmodel, params, stats, batch, weights, loss, monkeypatch):
    """The JAX step in float64 (module docstring); results as float32."""
    from avec_tpu.ops import layers as jlayers

    to64 = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), tree)
    with jax.enable_x64(True), monkeypatch.context() as mp:
        mp.setattr(jlayers, "jnp", _Float64())
        mp.setattr(jlosses, "jnp", _Float64())
        out = _jax_step(jmodel, to64(params), to64(stats),
                        {"inputs": np.asarray(batch["inputs"], np.float64),
                         "targets": batch["targets"]}, weights, loss)
        return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _jax_step(jmodel, params, stats, batch, weights, loss):
    inputs = batch["inputs"]
    inputs = inputs if isinstance(inputs, list) else [inputs]
    names = sorted(jax.eval_shape(
        lambda p, s: jmodel.apply_net(p, s, inputs, False)[0],
        params, stats))
    jmodel.compile(losses=loss, loss_weights=weights)
    proto = {k: None for k in names}
    jmodel.output_names = names
    jmodel.losses = jmodel.map_to_outputs(proto, jmodel.compiled_losses)
    jmodel.loss_weights = jmodel.map_to_outputs(
        proto, jmodel.compiled_loss_weights)
    targets = batch["targets"]
    targets = (tuple(jnp.asarray(a) for a in targets)
               if isinstance(targets, tuple) else jnp.asarray(targets))
    targets = jmodel._map_targets(targets)
    rngs = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}

    def loss_fn(p):
        outputs, new_bs, _, _ = jmodel.apply_net(p, stats, inputs, True,
                                                 rngs, with_aux=True)
        losses = jmodel._compute_losses(outputs, targets, 0)
        return losses["loss"], (losses, new_bs)

    grads, (losses, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return losses, grads, new_bs


@pytest.mark.parametrize("kind", ["ao", "ao_causal", "vo", "lrw"])
def test_zoo_dp_step_matches_jax_on_the_global_batch(kind, no_jax_noise,
                                                     monkeypatch):
    if kind in ("vo", "lrw"):
        monkeypatch.setattr(jzoo, "VisualEfficientConformerEncoder",
                            functools.partial(
                                jenc.VisualEfficientConformerEncoder,
                                num_blocks=ZOO_DP[kind][1]["num_blocks"]))
    jmodel, batch, weights, loss = _setup(kind)
    inputs = batch["inputs"]
    first = [a[:1] for a in (inputs if isinstance(inputs, list)
                             else [inputs])]
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *first, training=False))
    params, stats = random_variables(shapes, seed=0)
    step = (functools.partial(_jax_step64, monkeypatch=monkeypatch)
            if kind == "lrw" else _jax_step)
    want_losses, want_grads, want_bs = step(jmodel, params, stats, batch,
                                            weights, loss)
    state = {k: v.numpy() for k, v in params_from_jax(params, stats).items()}
    ranks = spawn(zoo_dp_rank, 2, "gloo", "cpu", kind, state, batch, weights)

    per_step = ranks[0]["launches_per_step"]
    assert per_step == ranks[1]["launches_per_step"]
    n_conv = {per_step.get(k, 0) for k in CONV_DP}
    assert len(n_conv) == 1 and n_conv.pop() > 0, per_step
    assert per_step["fused_ffn_fwd"] == per_step["fused_ffn_bwd"] > 0
    got = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]
        assert r["grads_digest"] == got["grads_digest"]
    assert set(got["losses"]) == {k for k in map(str, want_losses)}
    for k, w in want_losses.items():
        assert got["losses"][k] == pytest.approx(float(w), rel=1e-4), k
    values = {n: torch.from_numpy(v) for n, v in {
        **got["grads"], **got["buffers"]}.items()}
    got_grads, got_bs = state_to_jax(values, params, stats)
    got_grads, want = dict(_leaves(got_grads)), dict(_leaves(want_grads))
    assert got_grads.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(got_grads[k] - w).max()
        tol = 0.15 if "/front_end_" in k else 2e-3
        assert err <= tol * np.abs(w).max() + 1e-7, (kind, k, err)
    for (k, g_), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
        assert k == k2
        np.testing.assert_allclose(g_, w, rtol=0, atol=1e-5,
                                   err_msg=f"{kind} {k}")
    assert len({r["params_digest"] for r in ranks}) == 1
    trainable = [n for n in state if "running_" not in n
                 and "num_batches" not in n]
    assert got["moved"] >= 0.99 * len(trainable)
