"""CTC helpers (port of avec_tpu/ops/ctc.py:241)."""

from typing import Tuple

import torch


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
