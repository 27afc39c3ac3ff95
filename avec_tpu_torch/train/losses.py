"""Training losses (port of avec_tpu/train/losses.py and avec_tpu/ops/ctc.py:215).

CTC is plain XLA in the JAX package, so here it is the library's
`torch.nn.functional.ctc_loss` on an fp32 `log_softmax`; the softmax
cross-entropy of the classifiers is an fp32 `log_softmax` and a gather.
"""

import torch
import torch.nn.functional as F

REDUCTIONS = ("mean", "sum", "default", "none")


def rank_weight(reduction: str, world_size: int) -> float:
    """The weight of one rank's loss, taken on its equal shard of a global
    batch, in the loss of the global batch: 1 / world_size for the means
    ("mean", "default"), 1 for "sum". Summing the weighted losses, and the
    gradients taken from them, over the ranks gives the global-batch loss
    and its gradient."""
    if reduction not in ("mean", "sum", "default"):
        raise ValueError(f"reduction {reduction!r} has no global-batch form")
    return 1.0 if reduction == "sum" else 1.0 / world_size


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank: int = 0,
             reduction: str = "mean", zero_infinity: bool = False):
    """CTC loss over raw logits (B, T, V), computed in fp32 (ctc.py:215-238).

    reduction: "none" (B,) per-sample NLL; "mean" their mean; "sum" their
    sum; "default" divides each by its target length (at least 1), then
    takes the mean. zero_infinity gives an infeasible sample a loss of 0 with
    a zero gradient."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction {reduction!r} not in {REDUCTIONS}")
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    nll = F.ctc_loss(log_probs, labels.long(), logit_lengths.long(),
                     label_lengths.long(), blank=blank, reduction="none",
                     zero_infinity=zero_infinity)
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    denom = torch.clamp(label_lengths.to(nll.dtype), min=1.0)
    return (nll / denom).mean()


class CTCLoss:
    """CTC over (y, y_len) targets and (logits, logits_len) outputs
    (losses.py:164-184). `assert_shorter` is kept for the configs, as in the
    JAX package, which leaves that check to the host's data pipeline; the
    loss itself does not check it."""

    def __init__(self, blank: int = 0, reduction: str = "mean",
                 zero_infinity: bool = False, assert_shorter: bool = True):
        if reduction not in ("mean", "sum", "default"):
            raise ValueError(f"reduction {reduction!r}")
        self.blank = blank
        self.reduction = reduction
        self.zero_infinity = zero_infinity
        self.assert_shorter = assert_shorter

    def __call__(self, targets, outputs):
        y, y_len = targets
        logits, logits_len = outputs
        return ctc_loss(logits, logits_len, y, y_len, blank=self.blank,
                        reduction=self.reduction,
                        zero_infinity=self.zero_infinity)


class SoftmaxCrossEntropy:
    """Cross-entropy of integer targets over logits (..., V), in fp32
    (losses.py:136-161): targets equal to `ignore_index` add 0, and the
    mean runs over every element, ignored ones included. The logits always
    have the vocabulary last: `transpose_logits` is accepted for the
    configs and changes nothing, as in the JAX package."""

    def __init__(self, ignore_index: int = -1, transpose_logits: bool = False,
                 reduction: str = "mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"reduction {reduction!r}")
        self.ignore_index = ignore_index
        self.reduction = reduction

    def __call__(self, targets, outputs):
        y = torch.as_tensor(targets, device=outputs.device)
        valid = y != self.ignore_index
        logp = torch.log_softmax(outputs.float(), dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, y, 0).long()
                            [..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return nll.mean() if self.reduction == "mean" else nll.sum()
