"""RNN-Transducer loss (port of avec_tpu/ops/rnnt.py).

The log-domain alpha recursion over the (T, U + 1) lattice, a loop over the
frames of vectorised tensor operations on the input's device. The JAX
package scans the label axis within each frame:
new[u] = logaddexp(fb[u], new[u - 1] + lab[u - 1]), fb = alpha + blank;
with C[u] = lab[0] + ... + lab[u - 1] that row is
new = C + logcumsumexp(fb - C), one scan kernel per frame. Rows of frames
past a sample's logit length keep their alpha; positions past its label
length are at -1e30. Each frame's row is kept relative to its u = 0
entry, the offsets summed apart (a constant per row and frame, outside the
gradient): at T = 151 the row's values would otherwise reach about -800,
and their fp32 rounding put the gradient 1.6e-4 of its largest entry from
an fp64 evaluation (2.5e-5 with the offsets). The gradient comes from
autograd; the scan's own backward is the exact one, sum over u >= k of
g[u] exp(x[k] - out[u]), one batched product of weights that are all at
most 1 (the library's logcumsumexp backward subtracts two exponentiated
scans, whose rounding differs between the CPU and the card).
"""

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


class _LogCumSumExp(torch.autograd.Function):
    """logcumsumexp over dim 1 of (B, N), with the exact backward: the
    weights exp(x[k] - out[u]) for k <= u (`tril`, (N, N) bool) times the
    incoming gradient, summed over u."""

    @staticmethod
    def forward(ctx, x, tril):
        out = torch.logcumsumexp(x, dim=1)
        ctx.save_for_backward(x, out, tril)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out, tril = ctx.saved_tensors
        d = torch.where(tril, x[:, None, :] - out[:, :, None], float("-inf"))
        return torch.einsum("bu,buk->bk", grad, torch.exp(d)), None


def rnnt_forward_score(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                       labels: torch.Tensor, label_lengths: torch.Tensor,
                       blank: int = 0) -> torch.Tensor:
    """(B,) negative log likelihood (rnnt.py:27-88). log_probs: (B, T,
    U + 1, V) log-softmax outputs; labels (B, U)."""
    b, t, u1, _ = log_probs.shape
    u = u1 - 1
    if labels.shape[1] != u:
        raise ValueError(f"labels {tuple(labels.shape)} for U + 1 = {u1}")
    dev, dtype = log_probs.device, log_probs.dtype
    labels = labels.to(dev).long()
    label_lengths = label_lengths.to(dev).long()
    logit_lengths = logit_lengths.to(dev).long()
    blank_lp = log_probs[..., blank]                           # (B, T, U+1)
    label_lp = torch.gather(log_probs[:, :, :u], 3, labels[:, None, :, None]
                            .expand(b, t, u, 1))[..., 0]       # (B, T, U)
    u_valid = torch.arange(u1, device=dev)[None, :] <= label_lengths[:, None]
    neg = torch.full((), _NEG_INF, dtype=dtype, device=dev)
    first = torch.where(u_valid[:, 1:], label_lp[:, 0], neg)
    alpha = torch.where(u_valid, F.pad(torch.cumsum(first, dim=1), (1, 0)),
                        neg)
    # C[b, t, u]: the label log-probs of frame t summed below u; the scan
    # of frame t runs over alpha + blank(t - 1) - C(t)
    csum = F.pad(torch.cumsum(label_lp, dim=2), (1, 0))
    shift = blank_lp[:, :-1] - csum[:, 1:]
    tril = torch.ones(u1, u1, dtype=torch.bool, device=dev).tril()
    # a row changes at frame ti only inside the sample, and stays at -1e30
    # past its labels (where alpha already is)
    step = ((torch.arange(t, device=dev)[None, :] < logit_lengths[:, None])
            [:, :, None] & u_valid[:, None, :])
    active = step[:, :, :1].to(dtype)
    offset = torch.zeros((b, 1), dtype=dtype, device=dev)
    for ti in range(1, t):
        new = csum[:, ti] + _LogCumSumExp.apply(alpha + shift[:, ti - 1],
                                                tril)
        off = new[:, :1].detach() * active[:, ti]
        alpha = torch.where(step[:, ti], new - off, alpha)
        offset = offset + off
    tl = torch.clamp(logit_lengths - 1, min=0)
    a_final = alpha.gather(1, label_lengths[:, None])[:, 0] + offset[:, 0]
    blank_final = blank_lp[torch.arange(b, device=dev), tl, label_lengths]
    return -(a_final + blank_final)


def rnnt_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
              labels: torch.Tensor, label_lengths: torch.Tensor,
              blank: int = 0, reduction: str = "mean") -> torch.Tensor:
    """RNN-T loss over raw logits (B, T, U + 1, V), in fp32 (rnnt.py:91-101):
    reduction "none" (B,), "sum", or the mean over the batch."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = rnnt_forward_score(log_probs, logit_lengths, labels, label_lengths,
                             blank)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return nll.mean()


class RNNTLoss:
    """(targets=(y, y_len), outputs=(logits, logits_len)) callable
    (rnnt.py:104-116); `clamp` is accepted for the configs and unused, as
    in the JAX package."""

    def __init__(self, blank: int = 0, clamp: float = -1,
                 reduction: str = "mean"):
        self.blank = blank
        self.reduction = reduction

    def __call__(self, targets, outputs):
        y, y_len = targets
        logits, logits_len = outputs
        return rnnt_loss(logits, logits_len, y, y_len, blank=self.blank,
                         reduction=self.reduction)
