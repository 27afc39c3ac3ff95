"""The port's train step vs the JAX package: the slice as a whole.

Depths of configs/Synthetic/AV-Tone.py:72-75 (vocab 32), B=2 utterances of
1.7 s and 1 s, fp32 on the CPU, the loss weights of that config. Dropout and
SpecAugment are off on both sides: the two packages draw from different
random streams. On the JAX side that is done here, by replacing
`avec_tpu.ops.layers.Dropout.__call__` and
`avec_tpu.ops.audio.SpecAugment.__call__` with the identity for the duration
of a test; nothing in `avec_tpu/` changes. The JAX model runs with
use_flash=False, stem "2d" and the fused-FFN flag unset (the same function;
its Pallas paths run on the CPU only in interpret mode). The port runs
use_flash=True and the fused FFN through their plain versions, and, in
`test_unfused_ffn_train_step_matches_the_jax_default_step`, the unfused FFN
that is its own default too.

The flash path gives queries past an utterance's length a zero gradient
(the JAX flash VJP does the same), the unfused JAX path does not, and padded
frames do reach the losses through the convolution modules and the batch
statistics. So gradients are compared on a batch of equal lengths, and the
ragged batch holds losses and batch statistics (forward only).

Tolerances: the six losses 1e-4 relative; every gradient leaf 2e-3 of its
largest entry (fp32 sums in another order through ~60 layers; measured
5.5e-5 at worst outside the video front end) plus 1e-7
absolute, for the attention key biases and positional biases: each shifts
every score of a row alike, softmax ignores it, and both sides hold ~1e-9 of
rounding noise where the gradient is analytically zero; updated BN
statistics 1e-5. The leaves of the video front end (stem and ResNet18 trunk)
are held to 0.15 of their largest entry only: through 17 train-mode BatchNorms
over a batch of 52 frames their fp32 gradient is ill-conditioned, and the JAX
package's own fp32 gradient of the trunk differs from its float64 gradient by
up to 9e-2 of a leaf's largest entry on the CPU (the port's differs from JAX's
by as much, no more). Their building block, one residual block in training
mode, is held to 1e-4 in `test_resnet_block_train_gradients_match_jax`. The
optimizer is held separately, on identical gradients:
Adam's first step is -lr * g / (|g| + 1e-9), so parameters after a real step
would test the sign of rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.ops import audio as jaudio
from avec_tpu.ops import layers as jlayers
from avec_tpu.train import losses as jlosses
from avec_tpu.train.optim import Adam as JaxAdam
from avec_tpu.train.schedulers import NoamDecayScheduler as JaxNoam
from avec_tpu_torch.convert import (grads_to_jax_layout, params_from_jax,
                                    state_to_jax)
from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import AV_LOSS_WEIGHTS, Trainer
from avec_tpu_torch.train.optim import noam_adam

from test_torch_serve import AV_TONE
from test_torch_support import random_variables

torch.set_num_threads(1)

WEIGHTS = {"v_ctc_1": 0.5 / 4, "a_ctc_1": 0.5 / 4, "a_ctc_3": 0.5 / 4,
           "f_ctc_0": 0.5 / 4, "outputs": 0.5}
OUTPUTS = ["outputs", "f_ctc_0", "v_ctc_1", "a_ctc_1", "a_ctc_3"]


def _batch(audio_lens, seed=3):
    rng = np.random.RandomState(seed)
    alen = np.asarray(audio_lens, np.int32)
    b, ta = len(alen), int(alen.max())
    inputs = [rng.rand(b, ta // 640 + 1, 88, 88, 1).astype(np.float32),
              alen // 640 + 1,
              (rng.randn(b, ta) * 0.1).astype(np.float32), alen]
    targets = (rng.randint(1, 32, size=(b, 5)).astype(np.int32),
               np.array([5, 3][:b], np.int32))
    return {"inputs": inputs, "targets": targets}


@pytest.fixture
def no_jax_noise(monkeypatch):
    """Dropout and SpecAugment of the JAX package become the identity."""
    monkeypatch.setattr(jlayers.Dropout, "__call__",
                        lambda self, x, deterministic=True: x)
    monkeypatch.setattr(jaudio.SpecAugment, "__call__",
                        lambda self, x, lengths, rng, training=True: x)


@pytest.fixture(scope="module")
def av():
    """The JAX model with seeded variables, its loss wiring set by hand (a
    `build` would compile the net's init), and the variables themselves."""
    jmodel = jzoo.AudioVisualEfficientConformerInterCTC(use_flash=False,
                                                        **AV_TONE)
    jmodel.compile(losses=jlosses.CTCLoss(zero_infinity=True,
                                          assert_shorter=False),
                   loss_weights=WEIGHTS)
    proto = {k: None for k in OUTPUTS}
    jmodel.output_names = OUTPUTS
    jmodel.losses = jmodel.map_to_outputs(proto, jmodel.compiled_losses)
    jmodel.loss_weights = jmodel.map_to_outputs(proto,
                                                jmodel.compiled_loss_weights)
    args = _batch([16000])["inputs"]
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    params, stats = random_variables(shapes, seed=0)
    return jmodel, params, stats


def _port_trainer(params, stats, fused_ffn=True):
    model = AudioVisualEfficientConformerInterCTC(use_flash=True,
                                                  device="cpu",
                                                  fused_ffn=fused_ffn,
                                                  **AV_TONE)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True), loss_weights=WEIGHTS)
    trainer.model.set_regularization(False)
    return trainer


def _jax_step(jmodel, params, stats, batch):
    rngs = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}
    targets = jmodel._map_targets(
        tuple(jnp.asarray(a) for a in batch["targets"]))

    def loss_fn(p):
        outputs, new_bs, _, _ = jmodel.apply_net(p, stats, batch["inputs"],
                                                 True, rngs, with_aux=True)
        losses = jmodel._compute_losses(outputs, targets, 0)
        return losses["loss"], (losses, new_bs)

    grads, (losses, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return losses, grads, new_bs


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _check_step(trainer, losses, grads, want, params, stats):
    """The port's losses, gradients and BN statistics after one forward +
    backward against the JAX step's `want` (losses, gradients, statistics)
    at the tolerances of the module docstring."""
    want_losses, want_grads, want_bs = want
    assert set(losses) == set(want_losses) == {"loss"} | {
        "loss_" + k for k in OUTPUTS}
    for k, wl in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(wl), rel=1e-4), k
    got_grads = dict(_leaves(grads_to_jax_layout(grads, params)))
    want = dict(_leaves(want_grads))
    assert got_grads.keys() == want.keys()
    zero = [k for k, w in want.items() if not np.abs(w).max()]
    # the JAX package's exactly-zero bias gradients are exactly zero here too
    assert zero and all("Conv_1/bias" in k or "conv_0/bias" in k for k in zero)
    for k, w in want.items():
        assert got_grads[k].shape == w.shape, k
        err = np.abs(got_grads[k] - w).max()
        tol = 0.15 if "/front_end_" in k else 2e-3
        assert err <= tol * np.abs(w).max() + 1e-7, (k, err, np.abs(w).max())
        if not k.endswith(("key_layer/bias", "pos_bias")) and k not in zero:
            assert np.abs(w).max() > 1e-5, k          # the floor is idle
    _, got_bs = state_to_jax(trainer.model.state_dict(), params, stats)
    for (k, got), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
        assert k == k2
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=k)


def test_train_step_losses_and_gradients_match_jax(av, no_jax_noise):
    """The port's fused feed-forward route (`fused_ffn=True`, its plain
    version on the CPU) against the JAX package's default step."""
    jmodel, params, stats = av
    batch = _batch([16000, 16000])
    want = _jax_step(jmodel, params, stats, batch)
    trainer = _port_trainer(params, stats)
    assert trainer.model.kernel_launches_per_step()["fused_ffn_fwd"] == 20
    _check_step(trainer, *trainer.loss_and_grads(batch), want, params, stats)


def test_unfused_ffn_train_step_matches_the_jax_default_step(
        av, no_jax_noise, monkeypatch):
    """With AVEC_TPU_FUSED_FFN unset neither package fuses the feed-forward
    modules: the port's default (`fused_ffn=None`) runs LN -> Linear ->
    swish -> Dropout -> Linear -> Dropout (dropout off here), the JAX
    module's own default (conformer.py:130-139)."""
    from avec_tpu_torch.models.conformer import FeedForwardModule

    monkeypatch.delenv("AVEC_TPU_FUSED_FFN", raising=False)
    jmodel, params, stats = av
    batch = _batch([16000, 16000])
    want = _jax_step(jmodel, params, stats, batch)
    trainer = _port_trainer(params, stats, fused_ffn=None)
    ffns = [m for m in trainer.model.modules()
            if isinstance(m, FeedForwardModule)]
    assert len(ffns) == 20 and not any(m.fused_eligible() for m in ffns)
    assert "fused_ffn_fwd" not in trainer.model.kernel_launches_per_step()
    _check_step(trainer, *trainer.loss_and_grads(batch), want, params, stats)


def test_resnet_block_train_gradients_match_jax():
    """One residual block with a strided projection, train-mode BN: output,
    every parameter gradient and the input gradient to 1e-4 of the largest
    entry."""
    from avec_tpu.models.resnet import ResNetBlock as JaxBlock
    from avec_tpu_torch.models.resnet import ResNetBlock
    from test_torch_support import init_variables, t

    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(6, 10, 10, 16), 0).astype(np.float32)
    g = rng.randn(6, 5, 5, 32).astype(np.float32)
    jblock = JaxBlock(out_features=32, strides=(2, 2))
    params, stats = init_variables(jblock, jnp.asarray(x))

    def loss(p, x):
        y, _ = jblock.apply({"params": p, "batch_stats": stats}, x,
                            deterministic=False, mutable=["batch_stats"])
        return (y * g).sum(), y

    (want_p, want_x), want_y = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    block = ResNetBlock(16, 32, strides=2).train()
    tree = {"front_end_resnet": {"block_0": params}}
    sd = {k.split("blocks.0.")[1]: v
          for k, v in params_from_jax(
              tree, {"front_end_resnet": {"block_0": stats}}).items()}
    block.load_state_dict(sd, strict=True)
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = block(xt)
    (y * t(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y), atol=1e-5)
    grads = {"front_end.3.blocks.0." + n: p.grad
             for n, p in block.named_parameters()}
    got = dict(_leaves(grads_to_jax_layout(grads, tree)))
    for k, w in _leaves({"front_end_resnet": {"block_0": want_p}}):
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    gx = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.abs(gx - np.asarray(want_x)).max() <= 1e-4 * np.abs(gx).max()


def test_train_step_ragged_batch_losses_and_statistics(av, no_jax_noise):
    jmodel, params, stats = av
    batch = _batch([27200, 16000])
    want_losses, _, want_bs = _jax_step(jmodel, params, stats, batch)
    trainer = _port_trainer(params, stats)
    losses, infos = trainer.train_step(batch)
    for k, want in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(want), rel=1e-4), k
    _, got_bs = state_to_jax(trainer.model.state_dict(), params, stats)
    moved = 0
    for (k, got), (_, w), (_, old) in zip(_leaves(got_bs), _leaves(want_bs),
                                          _leaves(stats)):
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=k)
        moved += int(np.abs(got - old).max() > 1e-4)
    assert moved == len(list(_leaves(stats)))
    assert trainer.step == 1 and np.isfinite(float(infos["grad_norm"]))
    assert infos["lr"] == pytest.approx(JaxNoam(10000, 360, 2)(1))


def test_optimizer_matches_jax_on_identical_gradients():
    """Adam (L2 in the gradient) + Noam for 3 steps on the same numpy
    gradients: parameters equal to 1e-6."""
    rng = np.random.RandomState(0)
    shapes = {"w": (7, 5), "b": (5,), "s": (3, 2, 4)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: (rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
           for k, s in shapes.items()} for _ in range(3)]
    gs[1]["b"] = np.zeros(5, np.float32)              # a zero gradient decays
    jopt = JaxAdam(lr=JaxNoam(10000, 360, 2), betas=(0.9, 0.98), eps=1e-9,
                   weight_decay=1e-6)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = noam_adam(list(tp.values()))
    for step, g in enumerate(gs):
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     state, jp, step)
        jp = jax.tree.map(jnp.add, jp, updates)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        lr = topt.update(step)
        assert lr == pytest.approx(float(jopt.learning_rate(step)), rel=1e-9)
    for k in p0:
        assert np.abs(tp[k].detach().numpy() - p0[k]).max() > 0
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_grad_clipping_and_loss_weights():
    """grad_max_norm scales the gradients by max / (norm + 1e-6) before the
    update; the default weights are the reference's and are called at
    step + 1."""
    assert AV_LOSS_WEIGHTS["outputs"] == 0.5
    assert sum(AV_LOSS_WEIGHTS.values()) == pytest.approx(0.5 + 5 * 0.5 / 3)
    seen = []
    model = AudioVisualEfficientConformerInterCTC(device="cpu", **AV_TONE)
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True), grad_max_norm=1.0,
                      loss_weights={"outputs": lambda s: seen.append(s) or 1.0})
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    losses, infos = trainer.train_step(_batch([16000]))
    assert seen == [1]
    gnorm = float(infos["grad_norm"])
    assert gnorm > 1.0
    clipped = torch.nn.utils.get_total_norm(
        [p.grad for p in trainer.model.parameters()])
    assert float(clipped) == pytest.approx(1.0 / (1.0 + 1e-6 / gnorm),
                                           rel=1e-4)
    changed = sum(not torch.equal(p, before[n])
                  for n, p in trainer.model.named_parameters())
    assert changed >= 0.99 * len(before)
