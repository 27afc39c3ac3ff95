"""The AV train step (port of avec_tpu/train/model.py:375-423 and :455-558
for accumulated_steps=1).

A batch is {"inputs": [video (B, Tv, 88, 88, 1), video_len (B,), audio
(B, Ta), audio_len (B,)], "targets": (labels (B, U), label_len (B,))} of
numpy arrays or tensors. One step runs the model in training mode, the six
CTC losses with their weights, the backward, the global gradient norm
(clipping only when `grad_max_norm` is set), Adam with L2 in the gradient
under the Noam schedule, and the step counter; it returns (losses, infos)
with `lr` and `grad_norm`. Activations run in `precision` on fp32 parameters.
EMA, gradient accumulation, the fit loop and checkpoints are not ported yet.
"""

from typing import Dict, Optional, Tuple

import torch

from avec_tpu_torch.models.zoo import (AudioVisualEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.optim import noam_adam
from avec_tpu_torch.train.schedulers import as_scheduler

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# avec_tpu/models/zoo.py:254-256 (configs/LRS23/AV/EffConfInterCTC.py:14-21)
AV_LOSS_WEIGHTS = {"v_ctc_2": 0.5 / 3, "v_ctc_5": 0.5 / 3, "a_ctc_7": 0.5 / 3,
                   "a_ctc_10": 0.5 / 3, "f_ctc_1": 0.5 / 3, "outputs": 0.5}


class Trainer:
    """Owns the model in training mode, its loss, optimizer and step counter.

    model_kwargs go to AudioVisualEfficientConformerInterCTC (defaults: the
    reference depth, vocab 256). `loss_weights` maps output names to numbers
    or step schedulers (default: the reference's; an output without an entry
    weighs 1). It runs on the card unless the caller passes device="cpu"."""

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 device="cuda", precision: str = "bfloat16", seed: int = 0,
                 loss: Optional[CTCLoss] = None,
                 loss_weights: Optional[Dict] = None,
                 grad_max_norm: Optional[float] = None, **model_kwargs):
        self.device = resolve_device(device)
        self.dtype = _DTYPES[precision]
        if model is None:
            model = AudioVisualEfficientConformerInterCTC(
                device=self.device,
                generator=torch.Generator().manual_seed(seed), **model_kwargs)
        self.model = model.train()
        self.model.set_generators(seed)
        self.loss = loss or CTCLoss()
        if loss_weights is None:
            loss_weights = AV_LOSS_WEIGHTS
        self.loss_weights = {k: as_scheduler(v)
                             for k, v in loss_weights.items()}
        self.optimizer = noam_adam(self.model.parameters())
        self.grad_max_norm = grad_max_norm
        self.step = 0

    def _to_device(self, batch) -> Tuple[list, tuple]:
        inputs = []
        for a in batch["inputs"]:
            t = torch.as_tensor(a).to(self.device)
            inputs.append(t.to(self.dtype) if t.is_floating_point() else t)
        targets = tuple(torch.as_tensor(a).to(self.device)
                        for a in batch["targets"])
        return inputs, targets

    def compute_losses(self, outputs, targets, step: int
                       ) -> Dict[str, torch.Tensor]:
        """Per-output losses and their weighted total, the weights called at
        step + 1 (model.py:375-423). Every output is held against the same
        targets."""
        losses = {}
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for key, out in outputs.items():
            loss = self.loss(targets, out)
            losses["loss_" + key] = loss
            weight = self.loss_weights.get(key)
            total = total + loss * (weight(step + 1) if weight else 1.0)
        if len(losses) > 1:
            return {"loss": total, **losses}
        return {"loss": total}

    def _forward_backward(self, batch) -> Dict[str, torch.Tensor]:
        inputs, targets = self._to_device(batch)
        self.model.train()
        self.optimizer.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(*inputs)
        losses = self.compute_losses(outputs, targets, self.step)
        losses["loss"].backward()
        # A detached conv bias has no gradient; the JAX package gives it an
        # exact zero, which still takes the optimizer's weight decay.
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return {k: v.detach() for k, v in losses.items()}

    def loss_and_grads(self, batch):
        """One forward + backward without an update: (losses, gradients by
        parameter name). The running BN statistics do move."""
        losses = self._forward_backward(batch)
        grads = {n: p.grad.detach().clone()
                 for n, p in self.model.named_parameters()}
        return losses, grads

    def train_step(self, batch):
        """One optimisation step: (losses, {"lr", "grad_norm"})."""
        losses = self._forward_backward(batch)
        grads = [p.grad for p in self.model.parameters()]
        gnorm = torch.nn.utils.get_total_norm(grads)
        if self.grad_max_norm is not None:
            # scales by min(1, max_norm / (norm + 1e-6)), as model.py:531-534
            torch.nn.utils.clip_grads_with_norm_(
                self.model.parameters(), self.grad_max_norm, gnorm)
        lr = self.optimizer.update(self.step)
        self.step += 1
        return losses, {"lr": lr, "grad_norm": gnorm}
