"""The reference's training steps and served logits, in fp32 with TF32 off.

`train_readings` follows the first steps of a training cell: the weighted
CTC losses of every head (`F.ctc_loss` on fp32 log-softmax, mean over the
batch, infeasible samples zero), the gradients averaged over the
micro-batches, and Adam with the L2 term in the gradient (betas, eps and the
Noam schedule as the configuration states them). It returns per step the
losses, after step 1 the gradient each leaf handed to the optimizer (with
its L2 term), and after the last step each leaf's change. Both take the
family's `reference_forward(ctx, P, B, spec, inputs)`.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.model import Ctx


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def noam(step: int, warmup: int, dim: int, factor: float) -> float:
    s = max(float(step), 1e-9)
    return factor * dim ** -0.5 * min(s * warmup ** -1.5, s ** -0.5)


def ctc_losses(outputs, labels, label_len, weights: Dict[str, float]):
    losses, total = {}, 0.0
    for key, (logits, lengths) in outputs.items():
        logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
        nll = F.ctc_loss(logp, labels.long(), lengths.long(),
                         label_len.long(), blank=0, reduction="none",
                         zero_infinity=True)
        losses[key] = nll.mean()
        total = total + weights.get(key, 1.0) * losses[key]
    losses["loss"] = total
    return losses


def train_readings(forward, spec: dict, train: dict,
                   P0: Dict[str, torch.Tensor], batches: List[dict],
                   seed: int, fp8: bool = False):
    """Follow len(batches) optimizer steps from the weights P0 (the names
    of the model's parameters; buffers are not read in training). Each
    batch is {"inputs": [...], "labels", "label_len"}, split into
    train["accumulated_steps"] micro-batches in order."""
    no_tf32()
    dev = next(iter(P0.values())).device
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    b1, b2 = train["betas"]
    eps, wd = train["eps"], train["weight_decay"]
    ctx = Ctx(True, seed, dev, fp8)
    accum = train["accumulated_steps"]
    steps = []
    first_grad = None
    for step, batch in enumerate(batches):
        grads = {k: torch.zeros_like(p) for k, p in P.items()}
        sums: Dict[str, float] = {}
        n = batch["labels"].shape[0]
        mb = n // accum
        for a in range(accum):
            sl = slice(a * mb, (a + 1) * mb)
            inputs = [x[sl] for x in batch["inputs"]]
            out = forward(ctx, P, {}, spec, inputs)
            losses = ctc_losses(out, batch["labels"][sl],
                                batch["label_len"][sl], train["loss_weights"])
            g = torch.autograd.grad(losses["loss"], list(P.values()),
                                    allow_unused=True)
            for (k, _), gk in zip(P.items(), g):
                if gk is not None:
                    grads[k] += gk
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach()) / accum
            del out, losses, g
        lr = noam(step + 1, *train["noam"])
        t = step + 1
        with torch.no_grad():
            for k, p in P.items():
                g = grads[k] / accum + wd * p
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                if step == 0:
                    if first_grad is None:
                        first_grad = {}
                    first_grad[k] = g.norm().item()
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        steps.append(sums)
        del grads
    change = {k: (P[k].detach() - P0[k].float()).norm().item() for k in P}
    return {"losses": steps, "grad_norm": first_grad, "change": change}


@torch.no_grad()
def eval_logits(forward, spec: dict, P, B, inputs, fp8: bool = False):
    """The eval forward's final logits and lengths (batch statistics from
    the running buffers, no dropout)."""
    no_tf32()
    out = forward(Ctx(False, fp8=fp8), P, B, spec, inputs)
    return out["outputs"]
