"""The port's train step with the fused attention module, the fused FFN and
the train-mode "pallas" stem vs the JAX package: the third slice as a whole.

Depths of configs/Synthetic/AV-Tone.py:72-75 (vocab 32), B=2 utterances of
1.7 s and 1 s (unequal lengths), fp32 on the CPU. The port runs
`fused_att=True`, stem "pallas", the fused FFN and `use_flash=False` through
the kernels' plain versions. The JAX step runs with AVEC_TPU_FUSED_ATT=1 and
AVEC_TPU_FUSED_FFN=1 set around the call, so its attention and feed-forward
modules go through their Pallas kernels in interpret mode, and with the stem
at "2d": the AV model does not hand `stem_interpret` down, so its "pallas"
stem cannot run on the CPU inside the whole model, and "2d" computes the same
function (`tests/test_torch_stem_train.py` holds the stem's kernel path).

Dropout and SpecAugment are off on both sides, as in
`tests/test_torch_train_step.py`; the JAX fused kernels carry their own
dropout, so the two fused entry points are wrapped for the duration of a test
to pass `drop_rate=0`. Nothing in `avec_tpu/` changes.

The fused module differentiates rows past an utterance's length like any
other, as the unfused JAX path does, so gradients are compared on the ragged
batch. Tolerances: losses 1e-4 relative; every gradient leaf 2e-3 of its
largest entry plus 1e-7 (the video front end 0.15: its fp32 gradient through
17 train-mode BatchNorms is ill-conditioned at this size, see
`tests/test_torch_train_step.py`); updated BN statistics 1e-5.
"""

import numpy as np
import pytest
import torch

from avec_tpu.ops import pallas_attention_module as jatt
from avec_tpu.ops import pallas_ffn as jffn
from avec_tpu_torch.convert import (grads_to_jax_layout, params_from_jax,
                                    state_to_jax)
from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
from avec_tpu_torch.ops.batch_norm import launches as bn_launches
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import Trainer

from test_torch_serve import AV_TONE
from test_torch_train_step import (OUTPUTS, WEIGHTS, _batch, _jax_step,
                                   _leaves, av, no_jax_noise)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX attention and feed-forward modules take their Pallas kernels
    (interpret mode on the CPU), with the kernels' own dropout off."""
    for mod, name in ((jatt, "fused_attention_module_3d"),
                      (jffn, "fused_ffn_3d")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _fn=fn, **kw: _fn(*a, **{**kw,
                                                           "drop_rate": 0.0}))
    monkeypatch.setenv("AVEC_TPU_FUSED_ATT", "1")
    monkeypatch.setenv("AVEC_TPU_FUSED_FFN", "1")


def _port_trainer(params, stats, **kwargs):
    model = AudioVisualEfficientConformerInterCTC(
        device="cpu", **{**AV_TONE, **kwargs})
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True), loss_weights=WEIGHTS)
    trainer.model.set_regularization(False)
    return trainer


def test_fused_train_step_matches_jax_on_a_ragged_batch(av, no_jax_noise,
                                                        jax_fused):
    jmodel, params, stats = av
    batch = _batch([27200, 16000])
    want_losses, want_grads, want_bs = _jax_step(jmodel, params, stats, batch)
    trainer = _port_trainer(params, stats, fused_att=True, fused_ffn=True,
                            stem_mode="pallas", use_flash=False)
    assert trainer.model.kernel_launches_per_step() == {
        "fused_ffn_fwd": 20, "fused_ffn_bwd": 20, "fused_att_fwd": 8,
        "fused_att_bwd": 8, "bn_relu_pool": 1, **bn_launches(30, 1)}
    losses, grads = trainer.loss_and_grads(batch)
    assert set(losses) == {"loss"} | {"loss_" + k for k in OUTPUTS}
    for k, want in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(want), rel=1e-4), k
    got_grads = dict(_leaves(grads_to_jax_layout(grads, params)))
    want = dict(_leaves(want_grads))
    assert got_grads.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(got_grads[k] - w).max()
        tol = 0.15 if "/front_end_" in k else 2e-3
        assert err <= tol * np.abs(w).max() + 1e-7, (k, err, np.abs(w).max())
    # the stem conv's bias gradient is an exact zero on the "pallas" route
    stem_bias = [k for k in got_grads
                 if k.endswith("front_end_stem/conv_0/bias")]
    assert len(stem_bias) == 1 and not np.abs(got_grads[stem_bias[0]]).max()
    _, got_bs = state_to_jax(trainer.model.state_dict(), params, stats)
    for (k, got), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
        assert k == k2
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_flash,want", [
    (False, {"fused_att_fwd": 19, "fused_att_bwd": 19}),
    (True, {"fused_att_fwd": 12, "fused_att_bwd": 12,
            "flash_attention_fwd": 7, "flash_attention_bwd_dq": 7,
            "flash_attention_bwd_dkv": 7}),
])
def test_gate_and_launch_counts_at_reference_depth(use_flash, want):
    """At reference depth (v (6, 1), a (5, 6, 1), f 5): without flash every
    RelPos1d block takes the fused module (7 audio, 7 video, 5 fusion; the
    five patch-attention blocks of audio stage 0 never do); with flash the
    audio RelPos1d blocks take flash and only the video and fusion blocks
    the fused module (conformer.py:172). Counted from the module tree of a
    CPU model."""
    model = AudioVisualEfficientConformerInterCTC(
        device="cpu", fused_att=True, fused_ffn=True, stem_mode="pallas",
        use_flash=use_flash)
    counts = model.kernel_launches_per_step()
    assert counts == {"fused_ffn_fwd": 48, "fused_ffn_bwd": 48,
                      "bn_relu_pool": 1, **want, **bn_launches(44, 1)}
    off = AudioVisualEfficientConformerInterCTC(
        device="cpu", fused_att=False, stem_mode="2d", use_flash=use_flash,
        **AV_TONE).kernel_launches_per_step()
    assert "fused_att_fwd" not in off and "bn_relu_pool" not in off


def test_trainer_passes_the_switches_through():
    trainer = Trainer(device="cpu", precision="float32", fused_att=True,
                      fused_ffn=True, stem_mode="pallas", **AV_TONE)
    model = trainer.model
    assert model.encoder.video_encoder.front_end["0"].mode == "pallas"
    blocks = model.encoder.audio_visual_encoder.conformer_blocks
    assert all(b.self_att_module.fused_att for b in blocks)
    assert all(b.ff_module1.fused_ffn and b.ff_module2.fused_ffn
               for b in blocks)
    losses, infos = trainer.train_step(_batch([27200, 16000]))
    assert np.isfinite(float(losses["loss"]))
    assert np.isfinite(float(infos["grad_norm"]))
