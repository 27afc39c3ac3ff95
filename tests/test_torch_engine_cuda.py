"""The training engine on the card: the AV-Tone setup (avec_tpu_torch/
configs/av_tone.py, the config's depth and widths) on the fused-conv route
(fused FFN, attention and convolution modules, stem "pallas"), bf16 on fp32
parameters, dropout and SpecAugment on.

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_engine_cuda.py -m cuda -q

Every test needs the card and skips without one (the CUDA kernels have no
CPU mode; the engine's CPU parity with the JAX package is
tests/test_torch_engine.py).
"""

import math

import pytest
import torch

from avec_tpu_torch.configs import av_tone
from avec_tpu_torch.ops import _cuda

ROUTE = dict(fused_ffn=True, fused_att=True, fused_conv=True,
             stem_mode="pallas")
KERNELS = {"fused_ffn_fwd", "fused_ffn_bwd", "fused_att_fwd", "fused_att_bwd",
           "fused_conv_stats", "fused_conv_fwd", "fused_conv_bwd1",
           "fused_conv_bwd2", "bn_relu_pool", "bn_stats", "bn_apply",
           "bn_bwd_reduce", "bn_bwd_dx"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(path, train_samples=320):
    return av_tone.build(str(path), device="cuda", route=ROUTE,
                         train_samples=train_samples, eval_samples=16)


@pytest.mark.cuda
def test_av_tone_fit_launches_every_training_kernel(cuda_device, tmp_path):
    """A 20-step fit: finite losses, and every kernel of the route launched
    exactly its count per step (from the module tree) times 20."""
    setup = _setup(tmp_path)
    per_step = setup.model.kernel_launches_per_step()
    assert set(per_step) == KERNELS
    torch.cuda.synchronize()
    _cuda.reset_launches()
    history = setup.trainer.fit(setup.train_loader, epochs=1,
                                steps_per_epoch=20, step_log_period=10)
    torch.cuda.synchronize()
    assert dict(_cuda.launches) == {k: 20 * v for k, v in per_step.items()}
    assert history[0]["steps"] == 20 and setup.trainer.step == 20
    assert all(math.isfinite(v) for v in history[0]["losses"].values())


@pytest.mark.cuda
def test_checkpoint_reload_gives_bit_identical_bf16_logits(cuda_device,
                                                            tmp_path):
    """Two steps with an EMA, a checkpoint, and a fresh setup that loads
    it: the same bf16 logits bit for bit, plain and through the EMA, and
    the same step."""
    setup = _setup(tmp_path / "a", train_samples=32)
    setup.trainer.set_ema(0.9)
    setup.trainer.fit(setup.train_loader, epochs=1, steps_per_epoch=2)
    path = str(tmp_path / "a" / "checkpoint.ckpt")
    setup.trainer.save(path)
    fresh = _setup(tmp_path / "b", train_samples=32)
    fresh.trainer.set_ema(0.9)
    fresh.trainer.load(path)
    assert fresh.trainer.step == 2
    batch = next(iter(setup.eval_loader))
    for use_ema in (False, True):
        outs = []
        for tr in (setup.trainer, fresh.trainer):
            tr.model.eval()
            with torch.no_grad():
                inputs, _ = tr._to_device(batch)
                outs.append(tr._eval_forward(inputs, use_ema)["outputs"])
        (a, la), (b, lb) = outs
        assert a.dtype == torch.bfloat16 and torch.equal(la, lb)
        assert torch.equal(a, b), use_ema
