"""Batched serving of the Efficient Conformer models (port of
tools/serve.py:57-286), in the modes of tools/serve.py:72-90: "av" the
audio-visual model, "ao" the audio-only model, "vo" the video-only model.

Requests are dicts of arrays, {"video": (Tv, 88, 88, 1) float32 frames at
25 fps, "audio": (Ta,) float32 samples at 16 kHz}, with what the mode reads:
"ao" feeds the audio alone, "vo" the video alone. A batch of requests is
padded to a power-of-two length bucket (in audio samples; a video frame
counts 640) and batch bucket, run through one forward, and collapsed
greedily on the device, or decoded by a beam decoder given as `decoder`
(`decode/beam.py`'s on the host, `decode/device_beam.py`'s on the card;
tools/serve.py:94-103, :231-248), which sees the real rows only; each
result carries its token ids (greedy) or its text (beam), latency and
real-time factor. Padding is masked by the model's length semantics, so
neither bucket nor batch padding changes a transcription.

Reading wav/mp4 files is not ported yet.
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       AudioVisualEfficientConformerInterCTC,
                                       VisualEfficientConformerInterCTC,
                                       resolve_device)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_MODELS = {"av": AudioVisualEfficientConformerInterCTC,
           "ao": AudioEfficientConformerInterCTC,
           "vo": VisualEfficientConformerInterCTC}


def _bucket(n: int, floor: int = 4000) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _batch_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class Server:
    """Serving loop: bucket -> forward -> greedy collapse -> token ids.

    model_kwargs go to the zoo model of `mode` (defaults: the reference
    depth, vocab 256; mode "ao" without InterCTC blocks, as tools/serve.py
    builds it). The activations run in `precision` (bf16 by default, as
    tools/serve.py); parameters stay fp32. `decoder`: None for greedy
    token ids, or a beam decoder (`CTCBeamSearchDecoder`,
    `CTCDeviceBeamSearchDecoder`) for strings."""

    # Batch-padding rows: zero audio/video with this many valid samples, so
    # every mask row has real frames (no all-masked attention).
    PAD_ROW_SAMPLES = 2560

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 device="cuda", precision: str = "bfloat16", seed: int = 0,
                 mode: str = "av", decoder=None, **model_kwargs):
        if mode not in _MODELS:
            raise ValueError(f"mode {mode!r} not in {sorted(_MODELS)}")
        self.mode = mode
        self.device = resolve_device(device)
        self.dtype = _DTYPES[precision]
        if model is None:
            if mode == "ao":
                model_kwargs.setdefault("interctc_blocks", ())
            model = _MODELS[mode](
                device=self.device,
                generator=torch.Generator().manual_seed(seed), **model_kwargs)
        self.model = model
        self.decoder = CTCGreedySearchDecoder()
        self.beam_decoder = decoder
        self.latencies: List[float] = []
        self.rtfs: List[float] = []

    @staticmethod
    def _request_samples(req) -> int:
        """A request's length in audio samples (a video frame counts 640)."""
        n = len(req.get("audio", ()))
        return int(n) if n else int(req["video"].shape[0] * 640)

    def _inputs_for_batch(self, reqs, bucket_len: int, batch_bucket: int):
        """Pad requests into one batch of the mode's inputs as numpy arrays
        (float32 / int32): [video, video_len, audio, audio_len] ("av"),
        [audio, audio_len] ("ao") or [video, video_len] ("vo")."""
        pad_samples = min(self.PAD_ROW_SAMPLES, bucket_len)
        out = []
        if self.mode != "ao":
            vb = bucket_len // 640 + 1
            vshape = reqs[0]["video"].shape[1:]
            video = np.zeros((batch_bucket, vb) + vshape, np.float32)
            vlens = np.full((batch_bucket,), pad_samples // 640 + 1, np.int32)
            for i, r in enumerate(reqs):
                video[i, :r["video"].shape[0]] = r["video"]
                vlens[i] = r["video"].shape[0]
            out += [video, vlens]
        if self.mode != "vo":
            audio = np.zeros((batch_bucket, bucket_len), np.float32)
            alens = np.full((batch_bucket,), pad_samples, np.int32)
            for i, r in enumerate(reqs):
                audio[i, :len(r["audio"])] = r["audio"]
                alens[i] = len(r["audio"])
            out += [audio, alens]
        return out

    def forward(self, inputs, dtype: Optional[torch.dtype] = None):
        """Padded numpy inputs -> (logits, lengths) on the device. Float
        inputs are cast to the activation dtype."""
        dtype = dtype or self.dtype
        args = []
        for a in inputs:
            t = torch.as_tensor(a).to(self.device)
            args.append(t.to(dtype) if t.is_floating_point() else t)
        return self.model(*args)["outputs"]

    def transcribe_batch(self, reqs: List[Dict], enqueue_times=None):
        """Serve requests as one device batch. Latency runs from
        enqueue_times[i] (default: now) to the moment the result is ready."""
        if enqueue_times is None:
            enqueue_times = [time.perf_counter()] * len(reqs)
        samples = [self._request_samples(r) for r in reqs]
        inputs = self._inputs_for_batch(reqs, _bucket(max(samples)),
                                        _batch_bucket(len(reqs)))
        logits, lengths = self.forward(inputs)
        if self.beam_decoder is not None:
            out = self.beam_decoder.device_fn((logits[:len(reqs)],
                                               lengths[:len(reqs)]))
            texts = self.beam_decoder(out)
        else:
            tokens, tok_lens = self.decoder.device_fn((logits, lengths))
            ids = self.decoder((tokens[:len(reqs)], tok_lens[:len(reqs)]))
        done = time.perf_counter()
        results = []
        for i, n in enumerate(samples):
            dt = done - enqueue_times[i]
            rtf = dt / max(n / 16000.0, 1e-6)
            self.latencies.append(dt)
            self.rtfs.append(rtf)
            out = ({"text": texts[i]} if self.beam_decoder is not None
                   else {"tokens": ids[i]})
            results.append({**out, "latency_s": round(dt, 4),
                            "rtf": round(rtf, 5), "batch_size": len(reqs)})
        return results

    def stats_summary(self):
        """Latency / RTF stats over the server's lifetime."""
        if not self.latencies:
            return {"requests": 0}
        lat = np.sort(np.asarray(self.latencies))
        return {"requests": int(lat.size),
                "latency_p50_s": float(lat[lat.size // 2]),
                "latency_p95_s": float(lat[min(lat.size - 1,
                                               int(lat.size * 0.95))]),
                "latency_mean_s": float(lat.mean()),
                "rtf_mean": float(np.mean(self.rtfs))}
