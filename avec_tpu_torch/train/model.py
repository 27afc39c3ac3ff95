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

`Trainer(data_parallel=True)` is the data-parallel step (the JAX package's
step on a batch sharded over the mesh's 'data' axis; the reference's DDP with
SyncBatchNorm): every rank of an initialized process group passes the same
global batch, takes its `shard_batch` slice, runs the model with sync-BN and
the kernels' DP forms (`set_data_parallel`), and sums the rank-weighted
gradients and losses in one flat all-reduce, so every rank holds the
gradient and losses of the global batch and takes the same Adam step.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from avec_tpu_torch.models.zoo import (AudioVisualEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.parallel.dist import shard_batch
from avec_tpu_torch.train.losses import CTCLoss, rank_weight
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
    weighs 1). It runs on the card unless the caller passes device="cpu".

    data_parallel=True needs the default `torch.distributed` process group
    (`avec_tpu_torch.parallel.dist.init_distributed`), over whose ranks the
    step runs. Rank 0's parameters and statistics are broadcast to the others
    at construction."""

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 device="cuda", precision: str = "bfloat16", seed: int = 0,
                 loss: Optional[CTCLoss] = None,
                 loss_weights: Optional[Dict] = None,
                 grad_max_norm: Optional[float] = None,
                 data_parallel: bool = False, **model_kwargs):
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
        self.group = None
        if data_parallel:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError("data_parallel=True needs an initialized "
                                   "process group: call avec_tpu_torch."
                                   "parallel.dist.init_distributed first")
            self.group = dist.group.WORLD
            self.model.set_data_parallel(self.group)
            self._broadcast_state()

    def _broadcast_state(self) -> None:
        """Rank 0's parameters and buffers on every rank, in one broadcast."""
        state = list(self.model.parameters()) + list(self.model.buffers())
        flat = torch.cat([t.detach().reshape(-1).float() for t in state])
        dist.broadcast(flat, src=0, group=self.group)
        with torch.no_grad():
            for t, v in zip(state, flat.split([t.numel() for t in state])):
                t.copy_(v.view_as(t))

    def _all_reduce(self, losses: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The global batch's gradients (into every .grad) and losses: each
        rank's weighted by `rank_weight` and summed in one all-reduce."""
        world = dist.get_world_size(self.group)
        weight = rank_weight(getattr(self.loss, "reduction", "mean"), world)
        params = list(self.model.parameters())
        keys = list(losses)
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [torch.stack([losses[k] for k in keys])])
        flat.mul_(weight)
        dist.all_reduce(flat, group=self.group)
        sizes = [p.numel() for p in params] + [len(keys)]
        *grads, reduced = flat.split(sizes)
        for p, g in zip(params, grads):
            p.grad.copy_(g.view_as(p))
        return dict(zip(keys, reduced.clone()))

    def _to_device(self, batch) -> Tuple[list, tuple]:
        if self.group is not None:
            world = dist.get_world_size(self.group)
            size = len(batch["inputs"][0])
            if size % world:
                raise ValueError(f"a global batch of {size} does not split "
                                 f"into {world} equal shards")
            batch = shard_batch(batch, self.group)
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
        losses = {k: v.detach() for k, v in losses.items()}
        return losses if self.group is None else self._all_reduce(losses)

    def loss_and_grads(self, batch):
        """One forward + backward without an update: (losses, gradients by
        parameter name), of the global batch in data-parallel mode. The
        running BN statistics do move."""
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
