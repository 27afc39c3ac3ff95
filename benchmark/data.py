"""The general traffic generator: utterances, labels and arrivals from a
traffic file's parameters and the run's seed.

Every seed gets the same multiset of sizes (utterance lengths evenly spread
over the file's range; inter-arrival gaps at the quantiles of the
exponential law), in an order drawn from the seed, so that seeds change
which utterances meet in a batch and not how much work a run holds.
Contents are drawn on the device in bulk: audio is 16 kHz noise under a
slowly varying envelope, video 25 fps 88 x 88 frames in [0, 1), labels ids
drawn from the file's range at its rate per second of audio.
"""

import numpy as np
import torch

SR = 16000
SAMPLES_PER_FRAME = 640            # 25 fps video against 16 kHz audio


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def torch_seed(seed: int, stream: int) -> int:
    return (int(seed) * 1000003 + stream) % (2 ** 63 - 1)


def utterance_samples(traffic: dict, n: int, seed: int) -> np.ndarray:
    """n lengths in samples, evenly spread over traffic["seconds"], in a
    seeded order."""
    lo, hi = traffic["seconds"]
    secs = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return (rng(seed, 1).permutation(secs) * SR).astype(np.int64)


def video_frames(samples: np.ndarray) -> np.ndarray:
    return samples // SAMPLES_PER_FRAME + 1


def audio(samples: np.ndarray, seed: int, device, width: int = 0):
    """(N, max(width, longest)) fp32 on `device`, zero past each length."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    n, t = len(samples), max(int(samples.max()), width)
    x = torch.randn((n, t), generator=gen, device=device)
    env = torch.rand((n, t // 1600 + 2), generator=gen, device=device)
    env = torch.repeat_interleave(env, 1600, dim=1)[:, :t]
    valid = (torch.arange(t, device=device)[None, :]
             < torch.as_tensor(samples, device=device)[:, None])
    return x * (0.05 + 0.3 * env) * valid


def video(frames: np.ndarray, seed: int, device, width: int = 0):
    """(N, max(width, longest), 88, 88, 1) fp32 frames on `device`."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 3))
    n, t = len(frames), max(int(frames.max()), width)
    x = torch.rand((n, t, 88, 88, 1), generator=gen, device=device)
    valid = (torch.arange(t, device=device)[None, :]
             < torch.as_tensor(frames, device=device)[:, None])
    return x * valid[:, :, None, None, None]


def labels(samples: np.ndarray, traffic: dict, seed: int):
    """(labels (N, U) int64, lengths (N,) int64) at the file's rate."""
    per_s, (lo, hi) = traffic["labels_per_second"], traffic["label_ids"]
    u = np.maximum(1, (samples / SR * per_s).astype(np.int64))
    out = np.zeros((len(samples), int(u.max())), np.int64)
    r = rng(seed, 4)
    for i, k in enumerate(u):
        out[i, :k] = r.integers(lo, hi + 1, k)
    return out, u


def arrival_gaps(rate: float, n: int, seed: int) -> np.ndarray:
    """n inter-arrival gaps in seconds at the quantiles of an exponential
    law of mean 1 / rate, in a seeded order."""
    q = (np.arange(n) + 0.5) / n
    return rng(seed, 5).permutation(-np.log1p(-q) / rate)


def real_seconds(samples) -> float:
    return float(np.sum(samples)) / SR
