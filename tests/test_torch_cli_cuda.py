"""The experiment CLI on the card: the flagship AV config trained through
`avec_tpu_torch.main.main(argv)` on the fused routes (AVEC_TPU_FUSED_FFN /
_ATT / _CONV = 1, AVEC_TPU_STEM = pallas; bf16 on fp32 parameters,
dropout and SpecAugment on, B=16 with 4 accumulated micro-batches), and the
audio-only config trained and beam-evaluated from a generated LRS tree.

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_cuda.py -m cuda -q

Every test needs the card and skips without one (the CUDA kernels have no
CPU mode; the CLI's CPU parity with the JAX package is
tests/test_torch_cli.py).
"""

import json
import math
import os

import pytest
import torch

from avec_tpu_torch import main as cli
from avec_tpu_torch.data.lrs_fixture import write_lrs_fixture
from avec_tpu_torch.ops import _cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTE = {"AVEC_TPU_FUSED_FFN": "1", "AVEC_TPU_FUSED_ATT": "1",
         "AVEC_TPU_FUSED_CONV": "1", "AVEC_TPU_STEM": "pallas"}
KERNELS = {"fused_ffn_fwd", "fused_ffn_bwd", "fused_att_fwd", "fused_att_bwd",
           "fused_conv_stats", "fused_conv_fwd", "fused_conv_bwd1",
           "fused_conv_bwd2", "bn_relu_pool", "bn_stats", "bn_apply",
           "bn_bwd_reduce", "bn_bwd_dx"}


def _config(name):
    return os.path.join(REPO, "avec_tpu_torch", "configs", name + ".py")


@pytest.fixture
def cuda_device(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("AVEC_TPU_LOG_FORMAT", "jsonl")
    return torch.device("cuda")


@pytest.mark.cuda
def test_lrs23_av_step_through_the_cli_launches_every_kernel(cuda_device,
                                                             monkeypatch):
    """One training step of the synthetic fallback, no evaluation: every
    kernel of the route launched its `kernel_launches_per_step` times the 4
    micro-batches; the losses finite; the checkpoint written."""
    for k, v in ROUTE.items():
        monkeypatch.setenv(k, v)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    args = cli.main(["-c", _config("lrs23_av"), "-m", "training",
                     "--epochs", "1", "--steps_per_epoch", "1",
                     "--eval_period_epoch", "0", "--step_log_period", "1"])
    torch.cuda.synchronize()
    trainer = args.setup.trainer
    per_step = trainer.model.kernel_launches_per_step()
    assert set(per_step) == KERNELS and args.setup.accumulated_steps == 4
    assert dict(_cuda.launches) == {k: 4 * v for k, v in per_step.items()}
    assert trainer.step == 1
    assert os.path.isfile(os.path.join(args.callback_path,
                                       "checkpoints_epoch_1_step_1.ckpt"))
    with open(os.path.join(args.callback_path, "logs",
                           "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["value"] for r in rows if r["tag"] == "Training-step/loss"]
    assert len(losses) == 1 and all(math.isfinite(v) for v in losses)


@pytest.mark.cuda
def test_lrs23_ao_from_a_generated_lrs_tree(cuda_device):
    """Two steps of the AO config from the generated LRS2 + LRS3 tree, then
    its evaluation through the config's beam decoder (beam 16, the ARPA):
    finite losses and WERs."""
    write_lrs_fixture("datasets", seed=0)
    args = cli.main(["-c", _config("lrs23_ao"), "-m", "training",
                     "--epochs", "1", "--steps_per_epoch", "2",
                     "--eval_steps", "1", "--saving_period_epoch", "0"])
    setup = args.setup
    assert [type(d).__name__ for d in setup.training_dataset.datasets] == \
        ["LRS", "LRS"]
    assert setup.decoder.beam_size == 16 and setup.decoder.lm is not None
    assert setup.trainer.step == 2
    losses, metrics = setup.trainer.evaluate(
        _eval_loader(args), eval_steps=1, recompute_metrics=True)
    assert all(math.isfinite(v) for v in losses.values())
    assert math.isfinite(metrics["wer"])


def _eval_loader(args):
    from avec_tpu_torch.cli import functions

    return functions.load_datasets(args)[1][0]
