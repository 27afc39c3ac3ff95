"""Host-side data transforms in numpy (port of avec_tpu/data/transforms.py).

Video is (T, H, W, C) float32 throughout. The random transforms take an
explicit `rng`: a `np.random.RandomState` (or None, numpy's global state)
draws with `randint` / `rand` in the JAX module's order, so a seeded
RandomState gives the JAX module's results; a `np.random.Generator` draws
the same quantities with `integers` / `random`.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np

Rng = Optional[Union[np.random.RandomState, np.random.Generator]]


def _randint(rng, low: int, high: int) -> int:
    """One integer in [low, high)."""
    if isinstance(rng, np.random.Generator):
        return int(rng.integers(low, high))
    return rng.randint(low, high)


def _rand(rng) -> float:
    """One float in [0, 1)."""
    if isinstance(rng, np.random.Generator):
        return float(rng.random())
    return rng.rand()


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class NormalizeVideo:
    """(x - mean) / std per channel."""

    def __init__(self, mean=(0.5,), std=(0.5,)):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, video):
        return (video - self.mean) / self.std


class DenormalizeVideo:
    """x * std + mean per channel."""

    def __init__(self, mean=(0.5,), std=(0.5,)):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, video):
        return video * self.std + self.mean


class RandomCrop:
    """Spatial random crop of (T, H, W, C): the row offset drawn first."""

    def __init__(self, size: Tuple[int, int], rng: Rng = None):
        self.size = size
        self.rng = rng if rng is not None else np.random

    def __call__(self, video):
        h, w = video.shape[1], video.shape[2]
        th, tw = self.size
        i = _randint(self.rng, 0, h - th + 1)
        j = _randint(self.rng, 0, w - tw + 1)
        return video[:, i:i + th, j:j + tw]


class CenterCrop:
    """Spatial centre crop of (T, H, W, C), offsets rounded down."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, video):
        h, w = video.shape[1], video.shape[2]
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return video[:, i:i + th, j:j + tw]


class RandomHorizontalFlip:
    """Flip the W axis with probability p (one uniform draw per call)."""

    def __init__(self, p: float = 0.5, rng: Rng = None):
        self.p = p
        self.rng = rng if rng is not None else np.random

    def __call__(self, video):
        if _rand(self.rng) < self.p:
            return video[:, :, ::-1].copy()
        return video


class TimeMaskSecond:
    """Time masking of (T, H, W, C) video in seconds: int(T / fps *
    num_mask_second) masks, each of a width drawn in [0, T_second * fps]
    then a start drawn in [0, T - width], filled with the video's mean
    (mean_frame) or 0; a width of 0 or of at least T draws no start."""

    def __init__(self, T_second: float, num_mask_second: float,
                 fps: float = 25.0, mean_frame: bool = True, rng: Rng = None):
        self.T = int(T_second * fps)
        self.num_mask_second = num_mask_second
        self.fps = fps
        self.mean_frame = mean_frame
        self.rng = rng if rng is not None else np.random

    def __call__(self, video):
        t = video.shape[0]
        m_t = int(t / self.fps * self.num_mask_second)
        fill = video.mean() if self.mean_frame else 0.0
        video = video.copy()
        for _ in range(m_t):
            width = _randint(self.rng, 0, self.T + 1) if self.T > 0 else 0
            if width == 0 or width >= t:
                continue
            start = _randint(self.rng, 0, t - width + 1)
            video[start:start + width] = fill
        return video


class BabbleNoise:
    """Babble-noise mixing at a random SNR: the SNR in dB drawn from SNR_db
    (None: clean), then the noise segment's start; the segment is scaled so
    that the signal / noise amplitude ratio is 10^(SNR / 20)."""

    def __init__(self, noise_file_path: Optional[str] = None,
                 noise: Optional[np.ndarray] = None,
                 SNR_db=(-5, 0, 5, 10, 15, 20, None), to_sample_rate=16000,
                 rng: Rng = None):
        from avec_tpu_torch.utils.media import read_audio, resample_audio

        if noise is None:
            noise, sr = read_audio(noise_file_path)
            if to_sample_rate is not None:
                noise = resample_audio(noise, sr, to_sample_rate)
        self.noise = np.asarray(noise, dtype=np.float32)
        self.SNR_db = list(SNR_db)
        self.rng = rng if rng is not None else np.random

    def __call__(self, audio):
        snr_db = self.SNR_db[_randint(self.rng, 0, len(self.SNR_db))]
        if snr_db is None:
            return audio
        snr = (10.0 ** (snr_db / 10.0)) ** 0.5
        n = audio.shape[-1]
        pos = _randint(self.rng, 0, self.noise.shape[-1] - n + 1)
        noise = self.noise[pos:pos + n]
        x_power = (audio ** 2).sum() / n
        noise_power = (noise ** 2).sum() / n
        noise = noise / snr * np.sqrt(x_power / max(noise_power, 1e-12))
        return audio + noise


def align_video_to_audio(video: np.ndarray, audio: np.ndarray) -> np.ndarray:
    """Zero-pad (or crop) video to Ta // 640 + 1 frames, so 25 fps video
    lines up with 16 kHz audio after the audio's 4x time downsampling
    (hop 160 x 2 x 2); the padding splits evenly, the odd frame at the
    end."""
    tv = video.shape[0]
    ta = audio.shape[0]
    padding = ta // (160 * 2 * 2) + 1 - tv
    pad_left = padding // 2
    pad_right = padding // 2 + padding % 2
    if padding < 0:
        return video[:ta // 640 + 1]
    return np.pad(video, ((pad_left, pad_right), (0, 0), (0, 0), (0, 0)))
