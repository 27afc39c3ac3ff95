"""CTC (port of avec_tpu/ops/ctc.py:45-239): the greedy collapse, and the
loss through the JAX package's own log-domain forward recursion.

`ctc_forward_score` runs the alpha recursion over the extended label
sequence (blank, y0, blank, y1, ..., blank; S = 2U + 1) as a loop over the
frames of vectorised tensor operations on the input's device, every state
past a sample's last frame frozen and every position past its labels at
-1e30; the gradient comes from autograd through that loop (the JAX
package's alpha-beta gradient is the same derivative). The training
engine's `train.losses.CTCLoss` keeps the library's `F.ctc_loss`.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def ctc_forward_score(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """(B,) negative log likelihood of each label sequence (ctc.py:196-212),
    as torch's CTCLoss(reduction="none"): log_probs (B, T, V) log-softmax
    outputs, logit_lengths (B,) valid frames, labels (B, U) padded ids,
    label_lengths (B,) valid labels."""
    b, t, _ = log_probs.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev, dtype = log_probs.device, log_probs.dtype
    labels = labels.to(dev).long()
    label_lengths = label_lengths.to(dev).long()
    logit_lengths = logit_lengths.to(dev).long()
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(s, device=dev)[None, :]
    valid_s = pos <= 2 * label_lengths[:, None]
    ext_m2 = F.pad(ext, (2, 0), value=blank)[:, :s]
    can_skip = (pos >= 2) & (ext != blank) & (ext != ext_m2)
    lp_ext = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, s))
    neg = torch.full((), _NEG_INF, dtype=dtype, device=dev)
    has_label = (label_lengths > 0)[:, None]
    alpha = torch.where(((pos == 0) | ((pos == 1) & has_label)) & valid_s,
                        lp_ext[:, 0], neg)
    # a state changes at frame ti only where ti is inside the sample
    step = ((torch.arange(t, device=dev)[None, :] < logit_lengths[:, None])
            [:, :, None] & valid_s[:, None, :])
    for ti in range(1, t):
        a_m1 = F.pad(alpha, (1, 0), value=_NEG_INF)[:, :s]
        a_m2 = torch.where(can_skip,
                           F.pad(alpha, (2, 0), value=_NEG_INF)[:, :s], neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a_m1), a_m2) + lp_ext[:, ti]
        alpha = torch.where(step[:, ti], new, alpha)
    last = 2 * label_lengths
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, neg)
    return -torch.logaddexp(a_last, a_prev)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "mean",
             zero_infinity: bool = False) -> torch.Tensor:
    """CTC loss over raw logits (B, T, V), in fp32 (ctc.py:215-238):
    reduction "none" (B,), "mean", "sum", or "default" (each divided by its
    target length, at least 1, then the mean). zero_infinity gives an
    infeasible sample (its NLL near 1e30) a loss of 0 with a zero
    gradient."""
    if reduction not in ("mean", "sum", "default", "none"):
        raise ValueError(f"reduction {reduction!r}")
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = ctc_forward_score(log_probs, logit_lengths, labels, label_lengths,
                            blank)
    if zero_infinity:
        nll = torch.where(nll >= -0.5 * _NEG_INF, nll.detach() * 0.0, nll)
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    denom = torch.clamp(label_lengths.to(nll.device, nll.dtype), min=1.0)
    return (nll / denom).mean()


def ctc_greedy_collapse(preds: torch.Tensor, lengths: torch.Tensor,
                        blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy CTC collapse on the device: drop repeats, then blanks.

    preds: (B, T) argmax ids; lengths: (B,) valid frames. Returns (tokens
    (B, T) left-packed with `blank` padding, token_lengths (B,))."""
    b, t = preds.shape
    pos = torch.arange(t, device=preds.device)
    valid = pos[None, :] < lengths.to(preds.device)[:, None]
    prev = torch.nn.functional.pad(preds, (1, 0), value=blank)[:, :t]
    keep = valid & (preds != blank) & (preds != prev)
    target = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    target = torch.where(keep, target, torch.full_like(target, t))
    out = torch.full((b, t + 1), blank, dtype=preds.dtype, device=preds.device)
    out.scatter_(1, target, preds)
    return out[:, :t], keep.sum(dim=1)
