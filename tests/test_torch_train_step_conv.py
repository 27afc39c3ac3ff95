"""The port's train step with the fused convolution module, the fused
attention module, the fused FFN and the train-mode "pallas" stem vs the JAX
package: the fourth slice as a whole, where every training kernel of the JAX
package runs.

Depths of configs/Synthetic/AV-Tone.py:72-75 (vocab 32), B=2 utterances of
1.7 s and 1 s (unequal lengths), fp32 on the CPU. The port runs
`fused_conv=True`, `fused_att=True`, stem "pallas", the fused FFN and
`use_flash=False` through the kernels' plain versions. The JAX step runs with
AVEC_TPU_FUSED_CONV=1, AVEC_TPU_FUSED_ATT=1 and AVEC_TPU_FUSED_FFN=1 set
around the call, so its convolution, attention and feed-forward modules go
through their Pallas kernels in interpret mode, and with the stem at "2d" (see
`tests/test_torch_train_step_fused.py` for why). The JAX fused entry points
carry their own dropout, so they are wrapped for the duration of a test to
pass `drop_rate=0`, and dropout and SpecAugment are off on both sides. Nothing
in `avec_tpu/` changes.

The fused convolution module normalises with statistics over all B T rows,
padding included, as the unfused BatchNorm does, so the ragged batch is
compared as it is. Tolerances as in that file: losses 1e-4 relative; every
gradient leaf 2e-3 of its largest entry plus 1e-7 (the video front end 0.15);
updated BN statistics 1e-5.
"""

import numpy as np
import pytest
import torch

from avec_tpu.ops import pallas_conv_module as jconv
from avec_tpu_torch.convert import grads_to_jax_layout, state_to_jax
from avec_tpu_torch.models.conformer import ConvolutionModule
from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
from avec_tpu_torch.ops.batch_norm import launches as bn_launches
from avec_tpu_torch.train.model import Trainer

from test_torch_serve import AV_TONE
from test_torch_train_step import (OUTPUTS, _batch, _jax_step,  # noqa: F401
                                   _leaves, av, no_jax_noise)
from test_torch_train_step_fused import _port_trainer, jax_fused  # noqa: F401

torch.set_num_threads(1)

CONV_COUNTS = ("fused_conv_stats", "fused_conv_fwd", "fused_conv_bwd1",
               "fused_conv_bwd2")


@pytest.fixture
def jax_fused_conv(jax_fused, monkeypatch):
    """As `jax_fused`, and the JAX convolution modules take their Pallas
    kernels too, with the kernels' own dropout off."""
    fn = jconv.fused_conv_module_3d
    monkeypatch.setattr(jconv, "fused_conv_module_3d",
                        lambda *a, **kw: fn(*a, **{**kw, "drop_rate": 0.0}))
    monkeypatch.setenv("AVEC_TPU_FUSED_CONV", "1")


def test_conv_train_step_matches_jax_on_a_ragged_batch(av, no_jax_noise,
                                                       jax_fused_conv):
    jmodel, params, stats = av
    batch = _batch([27200, 16000])
    want_losses, want_grads, want_bs = _jax_step(jmodel, params, stats, batch)
    trainer = _port_trainer(params, stats, fused_conv=True, fused_att=True,
                            fused_ffn=True, stem_mode="pallas",
                            use_flash=False)
    assert trainer.model.kernel_launches_per_step() == {
        "fused_ffn_fwd": 20, "fused_ffn_bwd": 20, "fused_att_fwd": 8,
        "fused_att_bwd": 8, "bn_relu_pool": 1,
        **{name: 7 for name in CONV_COUNTS}, **bn_launches(23, 1)}
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
    # the depthwise conv's bias gradient is an exact zero on the fused route
    fused = [n for n, m in trainer.model.named_modules()
             if isinstance(m, ConvolutionModule) and m.fused_eligible()]
    assert len(fused) == 7
    for n in fused:
        assert not grads[n + ".layers.3.bias"].abs().any(), n
    _, got_bs = state_to_jax(trainer.model.state_dict(), params, stats)
    for (k, got), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
        assert k == k2
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=k)


def test_conv_gate_and_launch_counts_at_reference_depth():
    """At reference depth (v (6, 1), a (5, 6, 1), f 5) the 21 stride-1
    blocks take the fused convolution module and the 3 strided ones (video
    stage 0, audio stages 0 and 1) do not: 21 launches of each of the four
    conv kernels per step, counted from the module tree of a CPU model."""
    model = AudioVisualEfficientConformerInterCTC(
        device="cpu", fused_conv=True, fused_att=True, fused_ffn=True,
        stem_mode="pallas", use_flash=False)
    assert model.kernel_launches_per_step() == {
        "fused_ffn_fwd": 48, "fused_ffn_bwd": 48, "fused_att_fwd": 19,
        "fused_att_bwd": 19, "bn_relu_pool": 1,
        **{name: 21 for name in CONV_COUNTS}, **bn_launches(23, 1)}
    convs = [m for m in model.modules() if isinstance(m, ConvolutionModule)]
    assert len(convs) == 24
    assert sorted(m.stride for m in convs if not m.fused_eligible()) == [2] * 3
    off = AudioVisualEfficientConformerInterCTC(
        device="cpu", fused_conv=False, **AV_TONE).kernel_launches_per_step()
    assert not set(CONV_COUNTS) & set(off)


def test_trainer_passes_the_conv_switch_through():
    trainer = Trainer(device="cpu", precision="float32", fused_conv=True,
                      **AV_TONE)
    blocks = trainer.model.encoder.audio_visual_encoder.conformer_blocks
    assert all(b.conv_module.fused_conv for b in blocks)
    losses, infos = trainer.train_step(_batch([27200, 16000]))
    assert np.isfinite(float(losses["loss"]))
    assert np.isfinite(float(infos["grad_norm"]))
