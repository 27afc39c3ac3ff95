"""The grouped-attention audio-only model and the objectives of the rest of
the library on the card.

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_library_cuda.py -m cuda -q

Every test is marked `cuda` and skips without a card. The grouped model is
small (blocks (1, 1, 1), vocab 32) and fp32: its served forward through the
kernel route against the plain route (no kernel launched: the grouped
attention is plain products) and against the CPU, logits 2e-3 with
identical greedy ids; its fused-route train step against the plain route,
total loss 1e-5 relative, every gradient leaf 2e-3 of its largest entry
(leaves below 1e-6 of the largest gradient entry left out). `rnnt_loss` on
the card against the CPU: loss 1e-4 relative, gradient 1e-4 of its largest
entry; the CTC recursion against `F.ctc_loss` on the card, 1e-4 relative.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avec_tpu_torch.models import zoo
from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.batch_norm import launches as bn_launches
from avec_tpu_torch.ops.ctc import ctc_loss
from avec_tpu_torch.ops.rnnt import rnnt_loss
from avec_tpu_torch.serve import Server
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import Trainer

from test_torch_kernels import cuda_device  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(vocab_size=32, att_type="grouped", num_blocks=(1, 1, 1),
             interctc_blocks=(1, 2))


def _requests(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"audio": (rng.randn(int(16000 * s)) * 0.1).astype(np.float32)}
            for s in [3.0] + list(rng.uniform(1.0, 3.0, n - 1))]


@pytest.mark.cuda
def test_grouped_ao_served_forward_matches_plain_and_cpu(cuda_device):
    srv = Server(mode="ao", device="cuda", precision="float32", seed=0,
                 **SMALL)
    inputs = srv._inputs_for_batch(_requests(), 48000, 4)
    _cuda.reset_launches()
    srv.model.set_kernels(True)
    k_logits, k_len = srv.forward(inputs)
    assert dict(_cuda.launches) == {}
    srv.model.set_kernels(False)
    p_logits, p_len = srv.forward(inputs)
    srv.model.set_kernels(True)
    cpu = zoo.AudioEfficientConformerInterCTC(device="cpu", **SMALL)
    cpu.load_state_dict(srv.model.state_dict())
    with torch.no_grad():
        c_logits, c_len = cpu(*(torch.as_tensor(a) for a in inputs))["outputs"]
    ids = lambda lg, ln: srv.decoder(srv.decoder.device_fn((lg, ln)))
    for logits, lengths in ((p_logits, p_len),
                            (c_logits.cuda(), c_len.cuda())):
        assert float((k_logits - logits).abs().max()) <= 2e-3
        assert torch.equal(k_len, lengths)
        assert ids(k_logits, k_len) == ids(logits, lengths)


def _grad_leaves(model, batch):
    trainer = Trainer(model=model, device="cuda", precision="float32",
                      loss=CTCLoss(zero_infinity=True))
    losses, grads = trainer.loss_and_grads(batch)
    return float(losses["loss"]), grads


@pytest.mark.cuda
def test_grouped_ao_train_step_kernel_path_matches_plain_path(cuda_device):
    model = zoo.AudioEfficientConformerInterCTC(
        device="cuda", fused_ffn=True, fused_att=True, fused_conv=True,
        **SMALL)
    assert model.kernel_launches_per_step() == {
        "fused_ffn_fwd": 6, "fused_ffn_bwd": 6, "fused_conv_stats": 1,
        "fused_conv_fwd": 1, "fused_conv_bwd1": 1, "fused_conv_bwd2": 1,
        **bn_launches(3)}
    model.train()
    model.set_regularization(False)
    rng = np.random.RandomState(1)
    alen = np.array([48000, 40000, 30000, 20000], np.int32)
    audio = (rng.randn(4, 48000) * 0.1).astype(np.float32)
    for i, n in enumerate(alen):
        audio[i, n:] = 0.0
    batch = {"inputs": [audio, alen],
             "targets": (rng.randint(1, 32, (4, 8)).astype(np.int32),
                         np.full((4,), 8, np.int32))}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    loss_k, grads_k = _grad_leaves(model, batch)
    model.load_state_dict(state)
    model.set_kernels(False)
    loss_p, grads_p = _grad_leaves(model, batch)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    for name, gp in grads_p.items():
        leaf = float(gp.abs().max())
        if leaf <= 1e-6 * gmax:
            continue
        assert float((grads_k[name] - gp).abs().max()) <= 2e-3 * leaf, name


@pytest.mark.cuda
def test_rnnt_and_ctc_losses_on_the_card_match(cuda_device):
    gen = torch.Generator().manual_seed(0)
    b, t, u, v = 4, 60, 12, 64
    logits = torch.randn(b, t, u + 1, v, generator=gen)
    t_len = torch.tensor([60, 51, 40, 13])
    labels = torch.randint(1, v, (b, u), generator=gen)
    u_len = torch.tensor([12, 9, 5, 0])
    out = []
    for device in ("cpu", "cuda"):
        x = logits.to(device, copy=True).requires_grad_(True)
        loss = rnnt_loss(x, t_len.to(device), labels.to(device),
                         u_len.to(device))
        loss.backward()
        out.append((float(loss.detach()), x.grad.cpu()))
    (lc, gc), (lg, gg) = out
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())

    c_logits = torch.randn(8, 40, 32, generator=gen).cuda()
    lens = torch.tensor([40, 38, 35, 30, 28, 25, 22, 20], device="cuda")
    labs = torch.randint(1, 32, (8, 10), generator=gen).cuda()
    ulens = torch.tensor([10, 9, 8, 8, 7, 6, 5, 4], device="cuda")
    got = ctc_loss(c_logits, lens, labs, ulens, reduction="none")
    want = F.ctc_loss(torch.log_softmax(c_logits, -1).transpose(0, 1),
                      labs.long(), lens.long(), ulens.long(),
                      reduction="none")
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-4
