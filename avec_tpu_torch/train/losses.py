"""Training losses (port of avec_tpu/train/losses.py and avec_tpu/ops/ctc.py:215).

CTC is plain XLA in the JAX package, so the engine's `CTCLoss` is the
library's `torch.nn.functional.ctc_loss` on an fp32 `log_softmax` (the JAX
recursion itself is `ops/ctc.py:ctc_loss`); the softmax cross-entropy of
the classifiers is an fp32 `log_softmax` and a gather. The regression
losses (`MeanLoss`, `HingeLoss`, `MeanAbsoluteError`, `MeanSquaredError`,
`HuberLoss`) reduce through `Reduction` (losses.py:24-135).
"""

import torch
import torch.nn.functional as F

REDUCTIONS = ("mean", "sum", "default", "none")


class Reduction:
    """"sum", "mean" (over `n_elt` elements when given, else all of them)
    or "mean_batch" (the mean over axis 0, summed) (losses.py:24-37)."""

    def __init__(self, reduction: str = "mean"):
        if reduction not in ("sum", "mean", "mean_batch"):
            raise ValueError(f"reduction {reduction!r}")
        self.reduction = reduction

    def __call__(self, x, n_elt=None):
        if self.reduction == "sum":
            return x.sum()
        if self.reduction == "mean":
            return x.sum() / n_elt if n_elt is not None else x.mean()
        return x.mean(dim=0).sum()


def _targets(targets, outputs, fixed):
    """The targets as a tensor on the outputs' device, or `fixed` in the
    outputs' shape when the loss was given one."""
    if fixed is not None:
        return torch.full_like(outputs, fixed)
    return torch.as_tensor(targets, device=outputs.device)


def _one_hot(y, like):
    return F.one_hot(y.long(), like.shape[-1]).to(like.dtype)


class MeanLoss:
    """The mean of the outputs, negated where the target is 1 when
    `targets_as_sign` (losses.py:40-54)."""

    def __init__(self, targets_as_sign: bool = True, targets=None,
                 reduction: str = "mean"):
        self.targets_as_sign = targets_as_sign
        self.targets = targets
        self.reduction = Reduction(reduction)

    def __call__(self, targets, outputs):
        y = _targets(targets, outputs, self.targets)
        y_pred = torch.where(y == 1, -outputs, outputs) \
            if self.targets_as_sign else outputs
        return self.reduction(y_pred)


class HingeLoss:
    """relu(margin - y_pred) where the target is positive, relu(margin +
    y_pred) elsewhere (losses.py:57-71)."""

    def __init__(self, margin: float = 1.0, targets=None,
                 reduction: str = "mean"):
        self.margin = margin
        self.targets = targets
        self.reduction = Reduction(reduction)

    def __call__(self, targets, outputs):
        y = _targets(targets, outputs, self.targets)
        loss = torch.where(y > 0, torch.relu(self.margin - outputs),
                           torch.relu(self.margin + outputs))
        return self.reduction(loss)


class MeanAbsoluteError:
    """|y_pred - y|; with `masked` the outputs are (y_pred, mask) and the
    mean runs over the mask's nonzero entries (losses.py:74-96)."""

    def __init__(self, convert_one_hot: bool = False, masked: bool = False,
                 reduction: str = "mean"):
        self.convert_one_hot = convert_one_hot
        self.masked = masked
        self.reduction = Reduction(reduction)

    def __call__(self, targets, outputs):
        y_pred, mask = outputs if self.masked else (outputs, None)
        y = torch.as_tensor(targets, device=y_pred.device)
        if self.convert_one_hot:
            y = _one_hot(y, y_pred)
        loss = (y_pred - y).abs()
        if mask is not None:
            loss = loss * mask
            n = torch.count_nonzero(mask)
        else:
            n = loss.numel()
        return self.reduction(loss, n_elt=n)


class MeanSquaredError:
    """factor * (y_pred - y)^2 (losses.py:99-114)."""

    def __init__(self, convert_one_hot: bool = False, targets=None,
                 factor: float = 1.0, reduction: str = "mean"):
        self.convert_one_hot = convert_one_hot
        self.targets = targets
        self.factor = factor
        self.reduction = Reduction(reduction)

    def __call__(self, targets, outputs):
        y = _targets(targets, outputs, self.targets)
        if self.convert_one_hot:
            y = _one_hot(y, outputs)
        return self.reduction(self.factor * (outputs - y) ** 2)


class HuberLoss:
    """factor * (0.5 err^2 where err <= delta, else delta (err - delta / 2)),
    err = |y_pred - y| (losses.py:117-135)."""

    def __init__(self, convert_one_hot: bool = False, targets=None,
                 delta: float = 1.0, factor: float = 1.0,
                 reduction: str = "mean"):
        self.convert_one_hot = convert_one_hot
        self.targets = targets
        self.delta = delta
        self.factor = factor
        self.reduction = Reduction(reduction)

    def __call__(self, targets, outputs):
        y = _targets(targets, outputs, self.targets)
        if self.convert_one_hot:
            y = _one_hot(y, outputs)
        err = (outputs - y).abs()
        loss = torch.where(err <= self.delta, 0.5 * err ** 2,
                           self.delta * (err - 0.5 * self.delta))
        return self.reduction(self.factor * loss)


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


loss_dict = {
    "SoftmaxCrossEntropy": SoftmaxCrossEntropy,
    "CTC": CTCLoss,
}
