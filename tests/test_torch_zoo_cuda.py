"""The port's CUDA kernels at the shapes of the audio-only, causal, video-only
and LRW models, and those models' train steps through the kernels against
their plain versions.

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_zoo_cuda.py -m cuda -q

Every test is marked `cuda` and skips without a card (the kernels have no
CPU mode; on the CPU each wrapper computes its plain version, which the CPU
tests hold against the JAX package). The shapes: the convolution module at
the AO-Tone-Causal stages (B = 16; T = 61, 31, 16; d = 180, 256, 360;
padding "causal", pad_lo 14) and at the LRW clip's (B = 32; T = 29, 15;
"same"); the attention module at the LRW clip's without lengths; the stem
at 32 x 29 frames; the FFN at 32 x 29 rows. Tolerances as in
`tests/test_torch_kernels.py`: fp32 1e-4 (outputs) and 5e-4 (gradients, 3e-4
for the FFN's), bf16 2e-2 and 3e-2, of the largest entry; the stem's bf16
output exact. Train steps, fp32, dropout and SpecAugment off: total loss
1e-5 relative, every gradient leaf 2e-3 of its largest entry (leaves below
1e-6 of the largest gradient entry, the analytically zero biases, left
out).
"""

import numpy as np
import pytest
import torch

from avec_tpu_torch.models import zoo
from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.attention_module import fused_attention_module_3d
from avec_tpu_torch.ops.ffn import fused_ffn
from avec_tpu_torch.ops.stem import bn_relu_pool, bn_relu_pool_reference
from avec_tpu_torch.train.losses import CTCLoss, SoftmaxCrossEntropy
from avec_tpu_torch.train.model import Trainer

from test_torch_kernels import (_att_inputs, _conv_inputs, _conv_run, _err,
                                _ffn_inputs, _rel, cuda_device)  # noqa: F401

torch.set_num_threads(1)

TOLS = [(torch.float32, 1e-4, 5e-4), (torch.bfloat16, 2e-2, 3e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", TOLS)
@pytest.mark.parametrize("b,t,d,padding", [
    (16, 61, 180, "causal"), (16, 31, 256, "causal"), (16, 16, 360, "causal"),
    (32, 29, 256, "same"), (32, 15, 360, "same")])
def test_conv_module_kernels_match_plain_at_the_new_shapes(
        cuda_device, dtype, tol, wtol, b, t, d, padding):
    x, g, params = _conv_inputs(cuda_device, dtype, b, t, d, d, 15)
    got_out, got_grads = _conv_run(x, g, params, padding, 0.1, True)
    want_out, want_grads = _conv_run(x, g, params, padding, 0.1, False)
    for got, want in zip(got_out, want_out):
        assert _rel(got, want) <= tol
    for i, (got, want) in enumerate(zip(got_grads, want_grads)):
        if i == 6:                # the depthwise bias: detached, exactly 0
            assert not got.abs().any()
            continue
        assert _rel(got, want) <= (tol if i == 0 and dtype == torch.bfloat16
                                   else wtol), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", TOLS)
@pytest.mark.parametrize("t,d", [(29, 256), (15, 360)])
def test_attention_module_kernels_match_plain_at_the_lrw_clip(
        cuda_device, dtype, tol, wtol, t, d):
    """The LRW encoder has no lengths: every frame of a clip is valid."""
    x, g, params = _att_inputs(cuda_device, dtype, 32, t, d)
    outs, grads = [], []
    for use_kernel in (True, False):
        leaves = [a.detach().requires_grad_(True) for a in [x] + params]
        y = fused_attention_module_3d(
            leaves[0], *leaves[1:], num_heads=4, lengths=None, seed=7,
            drop_rate=0.1, deterministic=False, residual=False,
            use_kernel=use_kernel)
        y.backward(g)
        outs.append(y.detach())
        grads.append([a.grad for a in leaves])
    assert _rel(outs[0], outs[1]) <= tol
    gmax = max(float(a.float().abs().max()) for a in grads[1][1:])
    for i, (got, want) in enumerate(zip(*grads)):
        if float(want.float().abs().max()) <= 1e-6 * gmax:
            continue                       # the key bias: analytically zero
        assert _rel(got, want) <= (tol if i == 0 and dtype == torch.bfloat16
                                   else wtol), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0)])
def test_stem_kernel_matches_plain_at_the_lrw_batch(cuda_device, dtype, tol):
    gen = torch.Generator().manual_seed(3)
    y = torch.randn(32 * 29, 44, 44, 64, generator=gen).to(cuda_device, dtype)
    a = (torch.rand(64, generator=gen) + 0.5).to(cuda_device)
    b = (torch.randn(64, generator=gen) * 0.2).to(cuda_device)
    assert _err(bn_relu_pool(y, a, b), bn_relu_pool_reference(y, a, b)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 1e-4, 3e-4),
                                            (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("n,d", [(32 * 29, 256), (32 * 15, 360),
                                 (16 * 61, 180)])
def test_ffn_kernels_match_plain_at_the_new_shapes(cuda_device, dtype, tol,
                                                   wtol, n, d):
    x, params = _ffn_inputs(cuda_device, dtype, n, d, 4 * d)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(1)).to(
        cuda_device, dtype)
    outs, grads = [], []
    for use_kernel in (True, False):
        leaves = [a.detach().requires_grad_(True) for a in [x] + params]
        y = fused_ffn(leaves[0], *leaves[1:], seed=5, drop_rate=0.1,
                      train=True, use_kernel=use_kernel)
        y.backward(g)
        outs.append(y.detach())
        grads.append([a.grad for a in leaves])
    assert _rel(outs[0], outs[1]) <= tol
    for i, (got, want) in enumerate(zip(*grads)):
        assert _rel(got, want) <= (tol if i == 0 else wtol), i


def _batch(kind, rng):
    if kind == "lrw":
        return {"inputs": rng.rand(4, 9, 88, 88, 1).astype(np.float32),
                "targets": rng.randint(0, 20, 4).astype(np.int32)}
    alen = np.array([24000, 17000, 11000, 20000], np.int32)
    targets = (rng.randint(1, 16, (4, 6)).astype(np.int32),
               np.array([6, 4, 3, 5], np.int32))
    if kind in ("ao", "causal"):
        audio = (rng.randn(4, 24000) * 0.1).astype(np.float32)
        return {"inputs": [audio, alen], "targets": targets}
    frames = alen // 640 + 1
    video = rng.rand(4, int(frames.max()), 88, 88, 1).astype(np.float32)
    return {"inputs": [video, frames], "targets": targets}


def _model(kind, device):
    route = dict(fused_ffn=True, fused_att=True, fused_conv=True,
                 device=device)
    if kind == "ao":
        return zoo.AudioEfficientConformerInterCTC(
            vocab_size=16, num_blocks=(2, 2, 1), interctc_blocks=(2,),
            **route)
    if kind == "causal":
        return zoo.AudioEfficientConformerInterCTC(
            vocab_size=16, num_blocks=(2, 2, 1), interctc_blocks=(2,),
            causal=True, left_context=16, **route)
    if kind == "vo":
        return zoo.VisualEfficientConformerInterCTC(
            vocab_size=16, num_blocks=(2, 1), interctc_blocks=(1,),
            stem_mode="pallas", **route)
    return zoo.VisualEfficientConformerCE(vocab_size=20, num_blocks=(2, 1),
                                          stem_mode="pallas", **route)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ao", "causal", "vo", "lrw"])
def test_zoo_train_step_kernel_path_matches_plain_path(cuda_device, kind):
    """A forward + backward in fp32 through every kernel the model reaches
    (each launched as often as its module tree says) against the same
    through the kernels' plain versions (no launch)."""
    model = _model(kind, cuda_device)
    loss = SoftmaxCrossEntropy() if kind == "lrw" else CTCLoss(
        zero_infinity=True)
    trainer = Trainer(model=model, device=cuda_device, precision="float32",
                      loss=loss)
    model.set_regularization(False)
    batch = _batch(kind, np.random.RandomState(0))
    per_step = model.kernel_launches_per_step()
    assert per_step and all(per_step.values())
    runs = []
    for kernels in (True, False):
        model.set_kernels(kernels)
        n0 = dict(_cuda.launches)
        losses, grads = trainer.loss_and_grads(batch)
        torch.cuda.synchronize()
        launched = {k: v - n0.get(k, 0) for k, v in _cuda.launches.items()
                    if v - n0.get(k, 0)}
        assert launched == (per_step if kernels else {})
        runs.append((float(losses["loss"]), grads))
    (lk, gk), (lp, gp) = runs
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    gmax = max(float(g.abs().max()) for g in gp.values())
    for name, want in gp.items():
        if float(want.abs().max()) <= 1e-6 * gmax:
            continue
        assert _rel(gk[name], want) <= 2e-3, name
