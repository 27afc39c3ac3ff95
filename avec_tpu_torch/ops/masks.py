"""Attention / padding masks from sequence lengths (port of avec_tpu/ops/masks.py).

Masks are boolean (True = attend), (B, 1, 1, T) for key padding or
broadcastable to (B, 1, T, T) with a context band. Attention layers apply
`scores += (~mask) * -1e9`.
"""

from typing import Optional

import torch

NEG_INF = -1e9


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, 1, 1, T) key-padding mask."""
    return length_mask(lengths, max_len)[:, None, None, :]


def band_mask(seq_len: int, left_context: Optional[int],
              right_context: Optional[int], mask_start: int = 0,
              device=None) -> Optional[torch.Tensor]:
    """Context band mask (1, 1, T, T); None when unconstrained."""
    if left_context is None and right_context is None:
        return None
    rows = torch.arange(seq_len, device=device)[:, None]
    cols = torch.arange(seq_len, device=device)[None, :]
    mask = torch.ones((seq_len, seq_len), dtype=torch.bool, device=device)
    if right_context is not None:
        mask &= cols <= rows + right_context
    if left_context is not None:
        mask &= cols >= rows - left_context
    if mask_start > 0:
        mask |= (rows < mask_start) & (cols < mask_start)
    return mask[None, None]


def make_mask(seq_len: int, lengths: Optional[torch.Tensor] = None,
              left_context: Optional[int] = None,
              right_context: Optional[int] = None,
              mask_start: int = 0) -> Optional[torch.Tensor]:
    """Combined mask broadcastable to (B, 1, T, T); None when unmasked."""
    device = lengths.device if lengths is not None else None
    band = band_mask(seq_len, left_context, right_context, mask_start, device)
    if lengths is None:
        return band
    pad = padding_mask(lengths, seq_len)
    return pad if band is None else band & pad


def apply_mask(scores: torch.Tensor, mask: Optional[torch.Tensor]):
    """scores += (~mask) * -1e9 (the reference's additive masking)."""
    if mask is None:
        return scores
    return scores + (~mask).to(scores.dtype) * NEG_INF


def downsample_mask(mask: Optional[torch.Tensor], stride: int):
    """m[:, :, ::s, ::s]; the query stride is a no-op on key-padding masks."""
    if mask is None or stride == 1:
        return mask
    q = mask[:, :, ::stride, :] if mask.shape[2] > 1 else mask
    return q[:, :, :, ::stride]


def strided_lengths(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    """len -> (len - 1) // stride + 1."""
    if stride == 1:
        return lengths
    return torch.div(lengths - 1, stride, rounding_mode="floor") + 1


def min_pool_mask(mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Min-pool a (B, 1, Tq, Tk) mask by patch_size on both time axes
    (Tq may be the broadcast 1); T axes are padded to a multiple first."""
    b, h, tq, tk = mask.shape
    m = mask.reshape(b, h, tq, tk // patch_size, patch_size).all(dim=-1)
    if tq > 1:
        m = m.reshape(b, h, tq // patch_size, patch_size,
                      tk // patch_size).all(dim=3)
    return m
