"""The port's data-parallel train step (`Trainer(data_parallel=True)`) on 2
and 4 gloo ranks on the CPU vs the JAX step on the global batch: the fifth
slice as a whole.

Depths of configs/Synthetic/AV-Tone.py:72-75 (vocab 32), a global batch of 4
utterances of 0.5-1.2 s (unequal lengths, padded to the longest), fp32. Every
rank passes its `shard_batch` slice of the global batch to `Trainer`, so
each rank keeps the padded length and the batch statistics count the
padding rows as the single-process step does. The port runs
`fused_conv=True` (the K3dp plain stages), `fused_att=True`, the fused FFN
and stem "2d" in their data-parallel forms with sync-BN, and all-reduces the
rank-weighted gradients; the JAX step (`test_torch_train_step._jax_step`) runs
the whole batch on one device through the unfused layers, with dropout and
SpecAugment replaced by the identity, as there, and off on the port's side.

Tolerances, as in tests/test_torch_train_step.py: the six losses 1e-4
relative; every gradient leaf 2e-3 of its largest entry plus 1e-7 (the video
front end 0.15: its fp32 gradient is ill-conditioned at test sizes); updated
BN statistics 1e-5; for the "mean", "sum" and "default" reductions. Every rank
must hold the same losses and gradients, and after 2 steps with dropout and
SpecAugment on (each rank drawing its own masks) bit-identical parameters.
At world size 1 the data-parallel step equals the plain step exactly.
"""

import jax
import numpy as np
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.train import losses as jlosses
from avec_tpu_torch.convert import params_from_jax, state_to_jax
from avec_tpu_torch.parallel.dist import spawn
from avec_tpu_torch.train.model import Trainer

from test_torch_parallel import (dp_equals_plain_rank, pallas_stem_dp_rank,
                                 train_step_dp_rank)
from test_torch_serve import AV_TONE
from test_torch_support import random_variables
from test_torch_train_step import OUTPUTS, WEIGHTS, _batch, _jax_step, _leaves

torch.set_num_threads(1)

REDUCTIONS = ("mean", "sum", "default")
ROUTE = dict(use_flash=False, fused_att=True, fused_conv=True,
             fused_ffn=True, stem_mode="2d", **AV_TONE)


def _global_batch(seed=3):
    """4 utterances of 1.2, 0.7, 1.0 and 0.5 s (noise past each length, as
    in `test_torch_train_step._batch`), 5/3/4/2 labels."""
    rng = np.random.RandomState(seed)
    alen = np.array([19200, 11200, 16000, 8000], np.int32)
    b, ta = len(alen), int(alen.max())
    video = rng.rand(b, ta // 640 + 1, 88, 88, 1).astype(np.float32)
    audio = (rng.randn(b, ta) * 0.1).astype(np.float32)
    return {"inputs": [video, alen // 640 + 1, audio, alen],
            "targets": (rng.randint(1, 32, size=(b, 5)).astype(np.int32),
                        np.array([5, 3, 4, 2], np.int32))}


@pytest.fixture(scope="module")
def reference():
    """Seeded JAX variables, the port's state dict from them, and the JAX
    step on the global batch for each reduction (dropout and SpecAugment of
    the JAX package the identity for the duration)."""
    from avec_tpu.ops import audio as jaudio
    from avec_tpu.ops import layers as jlayers

    batch = _global_batch()
    jmodel = jzoo.AudioVisualEfficientConformerInterCTC(use_flash=False,
                                                        **AV_TONE)
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *_batch([16000])["inputs"],
        training=False))
    params, stats = random_variables(shapes, seed=0)
    steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers.Dropout, "__call__",
                   lambda self, x, deterministic=True: x)
        mp.setattr(jaudio.SpecAugment, "__call__",
                   lambda self, x, lengths, rng, training=True: x)
        for red in REDUCTIONS:
            jmodel.compile(losses=jlosses.CTCLoss(
                zero_infinity=True, assert_shorter=False, reduction=red),
                loss_weights=WEIGHTS)
            proto = {k: None for k in OUTPUTS}
            jmodel.output_names = OUTPUTS
            jmodel.losses = jmodel.map_to_outputs(proto,
                                                  jmodel.compiled_losses)
            jmodel.loss_weights = jmodel.map_to_outputs(
                proto, jmodel.compiled_loss_weights)
            steps[red] = _jax_step(jmodel, params, stats, batch)
    state = {k: v.numpy() for k, v in params_from_jax(params, stats).items()}
    return params, stats, state, batch, steps


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax_on_the_global_batch(world, reference):
    params, stats, state, batch, steps = reference
    ranks = spawn(train_step_dp_rank, world, "gloo", "cpu", state, ROUTE,
                  WEIGHTS, batch, REDUCTIONS, 2)
    assert ranks[0]["launches_per_step"] == {
        "fused_ffn_fwd": 20, "fused_ffn_bwd": 20, "fused_att_fwd": 8,
        "fused_att_bwd": 8, **{f"fused_conv_dp_{p}": 7
                               for p in ("stats", "fwd", "bwd1", "bwd2")}}
    for red in REDUCTIONS:
        want_losses, want_grads, want_bs = steps[red]
        got = ranks[0][red]
        for r in ranks[1:]:
            assert r[red]["losses"] == got["losses"], red
            assert r[red]["grads_digest"] == got["grads_digest"], red
        assert set(got["losses"]) == {"loss"} | {"loss_" + k for k in OUTPUTS}
        for k, want in want_losses.items():
            assert got["losses"][k] == pytest.approx(float(want), rel=1e-4), (
                red, k)
        values = {n: torch.from_numpy(v) for n, v in {
            **got["grads"], **got["buffers"]}.items()}
        got_grads, got_bs = state_to_jax(values, params, stats)
        got_grads, want = dict(_leaves(got_grads)), dict(_leaves(want_grads))
        assert got_grads.keys() == want.keys()
        for k, w in want.items():
            err = np.abs(got_grads[k] - w).max()
            tol = 0.15 if "/front_end_" in k else 2e-3
            assert err <= tol * np.abs(w).max() + 1e-7, (red, k, err)
        for (k, g_), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
            assert k == k2
            np.testing.assert_allclose(g_, w, rtol=0, atol=1e-5,
                                       err_msg=f"{red} {k}")
    assert len({r["params_digest"] for r in ranks}) == 1
    assert ranks[0]["moved"] >= 0.99 * len([n for n in state
                                            if "running_" not in n
                                            and "num_batches" not in n])


def test_world_one_dp_step_equals_the_plain_step(reference):
    """One rank: sync-BN, the K3dp stages, the DP seeds and the gradient
    all-reduce leave the step exactly as it is without them (dropout off)."""
    _, _, state, batch, _ = reference
    out, = spawn(dp_equals_plain_rank, 1, "gloo", "cpu", state, ROUTE,
                 WEIGHTS, batch)
    assert out == {"losses": 0.0, "grads": 0.0, "buffers": 0.0,
                   "keys_equal": True}


def test_pallas_stem_refuses_more_than_one_rank():
    with pytest.raises(ValueError, match="pallas"):
        spawn(pallas_stem_dp_rank, 2, "gloo", "cpu", AV_TONE)


def test_data_parallel_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(device="cpu", precision="float32", data_parallel=True,
                **AV_TONE)
