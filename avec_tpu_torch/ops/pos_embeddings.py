"""Sinusoidal positional encodings (port of avec_tpu/ops/pos_embeddings.py:
26-66).

Tables are computed for the sequence length at hand rather than sliced from
a stored 2 * max_len - 1 row buffer: the relative table lists the positions
T + Th - 1, ..., 1, 0, -1, ..., -(T - 1) (causal: down to 0), left context
positive, right context negative.
"""

import numpy as np
import torch


def _sinusoid(pos: torch.Tensor, dim_model: int) -> torch.Tensor:
    """(N,) float positions -> (N, dim_model): [:, 0::2] = sin and
    [:, 1::2] = cos of pos / 10000^(2i / dim_model), a zero column appended
    for an odd width."""
    i = np.arange(dim_model // 2, dtype=np.float32)
    inv_freq = torch.from_numpy(
        np.asarray(1.0 / (10000.0 ** (2.0 * i / dim_model)), np.float32))
    angles = pos[:, None] * inv_freq.to(pos.device)[None, :]
    out = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    out = out.reshape(pos.shape[0], -1)
    if dim_model % 2 == 1:
        out = torch.nn.functional.pad(out, (0, 1))
    return out


def sinusoidal_pos_encoding(seq_len: int, dim_model: int,
                            device=None) -> torch.Tensor:
    """(1, T, D) absolute sinusoidal encoding."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    return _sinusoid(pos, dim_model)[None]


def relative_pos_encoding(seq_len: int, dim_model: int, causal: bool = False,
                          hidden_len: int = 0, device=None) -> torch.Tensor:
    """(1, Th + 2T - 1, D) relative encoding, positions T + Th - 1 down to
    -(T - 1); causal: (1, Th + T, D), positions T + Th - 1 down to 0."""
    stop = -1 if causal else -seq_len
    pos = torch.arange(seq_len + hidden_len - 1, stop, -1,
                       dtype=torch.float32, device=device)
    return _sinusoid(pos, dim_model)[None]
