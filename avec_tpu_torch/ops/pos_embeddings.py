"""Positional encodings (port of avec_tpu/ops/pos_embeddings.py:26-115): the
sinusoidal tables and the additive absolute embeddings of the GPT.

Tables are computed for the sequence length at hand rather than sliced from
a stored 2 * max_len - 1 row buffer: the relative table lists the positions
T + Th - 1, ..., 1, 0, -1, ..., -(T - 1) (causal: down to 0), left context
positive, right context negative.
"""

import numpy as np
import torch
import torch.nn as nn


_DEVICE_CONSTANTS = {}


def device_constant(key, device, make) -> torch.Tensor:
    """`make()` (a CPU tensor) on `device`, copied once per (key, device):
    a host-to-device copy per call would wait for the device's queue."""
    full_key = (key, str(device))
    if full_key not in _DEVICE_CONSTANTS:
        with torch.inference_mode(False):     # usable by autograd later
            _DEVICE_CONSTANTS[full_key] = make().to(device)
    return _DEVICE_CONSTANTS[full_key]


def _inv_freq(dim_model: int, device) -> torch.Tensor:
    """(dim_model // 2,) fp32 1 / 10000^(2i / dim_model), computed in fp32
    by numpy."""
    def make():
        i = np.arange(dim_model // 2, dtype=np.float32)
        return torch.from_numpy(np.asarray(
            1.0 / (10000.0 ** (2.0 * i / dim_model)), np.float32))
    return device_constant(("sinusoid_inv_freq", dim_model), device, make)


def _sinusoid(pos: torch.Tensor, dim_model: int) -> torch.Tensor:
    """(N,) float positions -> (N, dim_model): [:, 0::2] = sin and
    [:, 1::2] = cos of pos / 10000^(2i / dim_model), a zero column appended
    for an odd width."""
    angles = pos[:, None] * _inv_freq(dim_model, pos.device)[None, :]
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


def grouped_relative_pos_encoding(seq_len: int, dim_model: int,
                                  group_size: int, causal: bool = False,
                                  hidden_len: int = 0,
                                  device=None) -> torch.Tensor:
    """Grouped relative encoding (pos_embeddings.py:68-85) for seq_len
    groups of `group_size` frames and hidden_len cached ones.

    Causal: positions T + Th - 1 down to 0. Full context: the left section
    T + Th - 1 - G // 2 down to G % 2 (1 for an odd G, 0 for an even G, so
    an even G lists position 0 twice), then the right section 0 down to
    -(T - G // 2 - 1). The table is made once per arguments and device."""
    def make():
        if causal:
            pos = np.arange(seq_len + hidden_len - 1, -1, -1)
        else:
            left = np.arange(seq_len + hidden_len - 1 - group_size // 2,
                             group_size % 2 - 1, -1)
            right = np.arange(0, -(seq_len - group_size // 2), -1)
            pos = np.concatenate([left, right])
        return _sinusoid(torch.from_numpy(pos.astype(np.float32)),
                         dim_model)[None]
    return device_constant(("grouped_rel_pos", seq_len, dim_model,
                            group_size, causal, hidden_len),
                           torch.device("cpu") if device is None else device,
                           make)


class SinPosEmbedding(nn.Module):
    """x + the absolute sinusoidal encoding of its T positions
    (pos_embeddings.py:88-98); no parameters."""

    def __init__(self, num_embeddings: int, dim_emb: int):
        super().__init__()
        self.num_embeddings, self.dim_emb = num_embeddings, dim_emb

    def forward(self, x):
        pe = sinusoidal_pos_encoding(x.shape[1], self.dim_emb, x.device)
        return x + pe.to(x.dtype)


class PosEmbedding1d(nn.Module):
    """x + a learned (num_embeddings, dim_emb) table's first T rows, zeros
    at init (pos_embeddings.py:101-115)."""

    def __init__(self, num_embeddings: int, dim_emb: int):
        super().__init__()
        self.pos_encoding = nn.Parameter(torch.zeros(num_embeddings, dim_emb))

    def init_(self, gen: torch.Generator):
        with torch.no_grad():
            self.pos_encoding.zero_()

    def forward(self, x):
        return x + self.pos_encoding[None, :x.shape[1]].to(x.dtype)
