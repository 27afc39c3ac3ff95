"""Log-mel filterbank front end (port of avec_tpu/ops/audio.py), fp32.

torchaudio-compatible: |STFT|^2 with n_fft 512, periodic hann window of 400
samples centred in n_fft, hop 160, reflect padding of n_fft//2; HTK mel
scale, 80 mels over 0-8 kHz, no norm; log(x + 1e-9); lengths // hop + 1.
The windowed real-DFT basis turns the STFT into one fp32 matmul, and the
mel filterbank is another. The JAX package runs both at Precision.HIGHEST,
so the port needs TF32 off for fp32 products on the card, PyTorch's default
(`torch.backends.cuda.matmul.allow_tf32` False): a caller that turns it on
changes the log-mels.
`AudioPreprocessing.stream_frames` computes the log-mels of an already
padded window, the chunked fbank of the causal streaming transcriber.

`SpecAugment` is the training-time augmentation of the audio encoder.
"""

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None):
    """Triangular HTK mel filterbank (n_freqs, n_mels), no norm."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max),
                                  n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis (n_fft, 2 * (n_fft//2 + 1)) [cos | -sin]."""
    n_freq = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length)
                                 / win_length))
    pad_l = (n_fft - win_length) // 2
    win_full = np.zeros(n_fft)
    win_full[pad_l:pad_l + win_length] = window
    angle = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_freq)[None] / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (basis * win_full[:, None]).astype(np.float32)


def spectrogram_frames(xp: torch.Tensor, n_frames: int, basis: torch.Tensor,
                       n_fft: int = 512, hop_length: int = 160
                       ) -> torch.Tensor:
    """(B, n_frames, n_fft//2 + 1) power spectrum of an already padded
    signal (B, L): frame f covers xp[:, f*hop : f*hop + n_fft), L at least
    (n_frames - 1) * hop + n_fft. fp32."""
    frames = xp.float().unfold(-1, n_fft, hop_length)[:, :n_frames]
    out = frames @ basis
    n_freq = n_fft // 2 + 1
    real, imag = out[..., :n_freq], out[..., n_freq:]
    return real * real + imag * imag


def power_spectrogram(x: torch.Tensor, basis: torch.Tensor, n_fft: int = 512,
                      hop_length: int = 160) -> torch.Tensor:
    """(B, T) -> (B, T // hop + 1, n_fft//2 + 1) power spectrum, fp32:
    reflect padding of n_fft // 2 (torch.stft's center=True), then
    `spectrogram_frames`."""
    pad = n_fft // 2
    xp = F.pad(x.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return spectrogram_frames(xp, x.shape[1] // hop_length + 1, basis, n_fft,
                              hop_length)


class AudioPreprocessing(nn.Module):
    """(B, T) audio -> (B, n_mels, T // hop + 1) log-mels in x's dtype, and
    lengths // hop + 1. Computed in fp32 whatever the input dtype."""

    def __init__(self, sample_rate=16000, n_fft=512, win_length_ms=25,
                 hop_length_ms=10, n_mels=80, normalize=False, mean=0.0,
                 std=1.0):
        super().__init__()
        self.n_fft = n_fft
        self.win_length = int(sample_rate * win_length_ms) // 1000
        self.hop_length = int(sample_rate * hop_length_ms) // 1000
        self.normalize, self.mean, self.std = normalize, mean, std
        self.register_buffer("basis", torch.from_numpy(
            _dft_basis(n_fft, self.win_length)), persistent=False)
        self.register_buffer("mel", torch.from_numpy(mel_filterbank(
            n_fft // 2 + 1, n_mels, sample_rate, 0.0, 8000.0)),
            persistent=False)

    def _log_mels(self, spec):
        out = torch.log(spec @ self.mel + 1e-9)
        if self.normalize:
            out = (out - self.mean) / self.std
        return out.transpose(1, 2)

    def forward(self, x, lengths=None):
        spec = power_spectrogram(x, self.basis, self.n_fft, self.hop_length)
        out = self._log_mels(spec).to(x.dtype)
        if lengths is None:
            return out
        return out, torch.div(lengths, self.hop_length,
                              rounding_mode="floor") + 1

    def stream_frames(self, xp, n_frames: int):
        """(B, n_mels, n_frames) log-mels, in xp's dtype, of an already
        padded chunk (B, L): frame f covers xp[:, f*hop : f*hop + n_fft)
        (audio.py:175-189)."""
        spec = spectrogram_frames(xp, n_frames, self.basis, self.n_fft,
                                  self.hop_length)
        return self._log_mels(spec).to(xp.dtype)


class SpecAugment(nn.Module):
    """SpecAugment with adaptive time masking (audio.py:191) on (B, n_mels, T)
    log-mels: mF frequency masks of width 0..F shared by the batch, and for
    each sample mT time masks of width 0..floor(pS * length) placed inside
    its valid frames; masked entries become 0. Active in training mode only
    (and only while `regularize`). The frequency bands are drawn from
    `band_generator` (None: `generator`) and the time masks from
    `generator`, `torch.Generator`s on x's device set by the owning model:
    in data-parallel training the first is the same on every rank, so the
    global batch gets one set of bands as in the JAX step, and the second is
    offset by the rank. Their streams are not JAX's, so only the masks'
    statistics match the JAX package."""

    def __init__(self, mF: int = 2, F: int = 27, mT: int = 5,
                 pS: float = 0.05):
        super().__init__()
        self.mF, self.F, self.mT, self.pS = mF, F, mT, pS
        self.regularize = True
        self.generator = None
        self.band_generator = None
        self.training = False

    def keep_mask(self, b: int, n_mels: int, t: int, lengths) -> torch.Tensor:
        """(B, n_mels, T) boolean mask of the entries that stay."""
        dev = lengths.device
        bands = (self.band_generator if self.band_generator is not None
                 else self.generator)

        def uniform(*shape, generator=self.generator):
            return torch.rand(shape, generator=generator, device=dev)

        keep = torch.ones((b, n_mels, t), dtype=torch.bool, device=dev)
        freq = torch.arange(n_mels, device=dev)
        for _ in range(self.mF):
            width = (uniform(generator=bands) * (self.F + 1)).long()
            room = torch.clamp(n_mels - width, min=0)
            start = (uniform(generator=bands) * (room + 1).float()).long()
            keep &= ~((freq >= start) & (freq < start + width))[None, :, None]
        time = torch.arange(t, device=dev)[None, :]
        lens = lengths.long()
        max_width = (self.pS * lens.float()).long()
        for _ in range(self.mT):
            width = (uniform(b) * (max_width + 1).float()).long()
            room = torch.clamp(lens - width, min=0)
            start = (uniform(b) * (room + 1).float()).long()
            tmask = ((time >= start[:, None])
                     & (time < (start + width)[:, None])
                     & (time < lens[:, None]))
            keep &= ~tmask[:, None, :]
        return keep

    def forward(self, x, lengths):
        if not (self.training and self.regularize):
            return x
        keep = self.keep_mask(x.shape[0], x.shape[1], x.shape[2], lengths)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
