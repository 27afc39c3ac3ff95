"""Streaming transcription over chunked audio, push / partial / final (port
of avec_tpu/decode/streaming.py), for the bidirectional audio models.

  * `push(pcm)` takes a chunk of 16 kHz float PCM and returns a revised
    partial transcript: the encoders are bidirectional, so later audio may
    revise earlier frames;
  * `finish()` returns the final transcript. With an unbounded window it is
    the offline greedy decode of the whole utterance, in the same length
    bucket.

Each forward is the model's own eval forward on the buffer padded to a
power-of-two length bucket (on the card the flash route of the model's
RelPos1d layers); the device returns per-frame argmax ids and the valid
length, and the collapse and commit logic runs on the host. With
`window_seconds`, memory is bounded: once the buffer exceeds the window,
tokens left of the commit horizon are frozen at a CTC blank-run boundary
(else a forced cut) and their audio is dropped. Windowed mode is
approximate by design (dropping left context perturbs later frames);
unbounded mode is exact.

Frames: 1280 samples per 12.5 Hz output frame (fbank hop 160 x stem stride 2
x stage strides 2 x 2).
"""

import logging
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = ["StreamingTranscriber"]

DTYPES = {None: torch.float32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def decode_text(decoder, ids: List[int]) -> str:
    """The decoder's tokenizer's text of `ids`; the ids joined by spaces
    where the decoder has no tokenizer."""
    tok = getattr(decoder, "tokenizer", None)
    if tok is None:
        return " ".join(map(str, ids))
    return tok.decode([ids])[0] if ids else ""


def _collapse_host(preds: np.ndarray, blank: int = 0,
                   prev: int = None) -> List[int]:
    """Greedy CTC collapse of a 1-D frame-argmax sequence on the host (drop
    repeats, then blanks). `prev` seeds the repeat suppression: after a
    forced window cut that may have landed inside a token, the frame id at
    the cut keeps that token from being emitted again at the head of the
    new window."""
    out: List[int] = []
    prev = blank if prev is None else prev
    for p in preds.tolist():
        if p != blank and p != prev:
            out.append(int(p))
        prev = p
    return out


def _find_blank_cut(preds: np.ndarray, horizon: int, blank: int = 0,
                    min_run: int = 2) -> int:
    """The latest frame index f <= horizon such that frames [f-min_run, f)
    are all blank, so committing at f cannot split a token; -1 if there is
    no such run."""
    horizon = min(horizon, len(preds))
    run = 0
    cut = -1
    for f in range(horizon):
        run = run + 1 if preds[f] == blank else 0
        if run >= min_run:
            cut = f + 1
    return cut


class StreamingTranscriber:
    """Incremental transcription for an audio-only port model.

    model: an audio model of the zoo (forward(audio, audio_len) ->
    {"outputs": [logits, lengths]}), with its weights; the transcriber
    puts it in eval mode. decoder:
    `CTCGreedySearchDecoder` (tokenizer and blank id). hop_seconds: the
    least new audio between device forwards; smaller pushes are buffered
    and return the previous partial. window_seconds: bound on the buffered
    audio; None is unbounded (exact). commit_margin_seconds: audio kept to
    the right of any commit cut, so frozen frames had at least this much
    right context. precision: "float32" (None) or "bfloat16"."""

    SAMPLE_RATE = 16000
    FRAME_SAMPLES = 1280  # 12.5 Hz encoder output on 16 kHz input
    UNBOUNDED_WARN_SECONDS = 60  # one-time O(T^2) cost warning threshold

    def __init__(self, model, decoder, hop_seconds: float = 0.48,
                 window_seconds: Optional[float] = None,
                 commit_margin_seconds: float = 1.0,
                 bucket_floor: int = 4000, precision: Optional[str] = None):
        # eval mode: batch norm on its running statistics, no dropout
        self.model = model.eval()
        self.decoder = decoder
        self.blank = getattr(decoder, "blank_token", 0)
        self.hop = max(1, int(hop_seconds * self.SAMPLE_RATE))
        self.window = (None if window_seconds is None
                       else int(window_seconds * self.SAMPLE_RATE))
        self.margin = int(commit_margin_seconds * self.SAMPLE_RATE)
        if (self.window is not None
                and self.window <= self.margin + self.FRAME_SAMPLES):
            raise ValueError("window must exceed the commit margin")
        self.bucket_floor = bucket_floor
        self.precision = precision
        self.dtype = DTYPES[precision]
        self.device = next(model.parameters()).device

        self._buffer = np.zeros((0,), np.float32)
        self._pending = 0          # samples since the last forward
        self._committed: List[int] = []  # frozen token ids
        self._fresh: List[int] = []      # tokens decoded from the live buffer
        self._carry = self.blank   # frame id at the last window cut
        self._fwd_cache = {}       # length buckets run: forwards per bucket
        self._finished = False
        self._warned_unbounded = False
        self.device_seconds = 0.0  # cumulative device + fetch time

    # ------------------------------------------------------------ device
    def _bucket(self, n: int) -> int:
        b = self.bucket_floor
        while b < n:
            b *= 2
        return b

    def _forward_preds(self, audio: np.ndarray) -> np.ndarray:
        """The model's eval forward on the buffer padded to its length
        bucket; the valid frames' argmax ids (1-D)."""
        bucket = self._bucket(len(audio))
        pad = np.zeros((1, bucket), np.float32)
        pad[0, : len(audio)] = audio
        self._fwd_cache[bucket] = self._fwd_cache.get(bucket, 0) + 1
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, lengths = self.model(
                torch.from_numpy(pad).to(self.device, self.dtype),
                torch.tensor([len(audio)], dtype=torch.int32,
                             device=self.device))["outputs"]
            preds = torch.argmax(logits, dim=-1)[0].cpu().numpy()
            nf = int(lengths[0])
        self.device_seconds += time.perf_counter() - t0
        return preds[:nf]

    # ------------------------------------------------------------- logic
    def _slide_window(self, preds: np.ndarray) -> np.ndarray:
        """Freeze tokens left of the commit horizon and drop their audio."""
        while self.window is not None and len(self._buffer) > self.window:
            overflow = len(self._buffer) - (self.window - self.hop)
            horizon = min(overflow + self.margin,
                          len(self._buffer) - self.margin)
            horizon_f = max(1, horizon // self.FRAME_SAMPLES)
            cut_f = _find_blank_cut(preds, horizon_f, self.blank)
            if cut_f <= 0:
                cut_f = horizon_f  # forced cut: the model emitted no blank run
            self._committed.extend(
                _collapse_host(preds[:cut_f], self.blank, prev=self._carry))
            # the frame id at the cut seeds the next collapse, so a token
            # split by a forced cut is not emitted twice (a blank-run cut
            # carries blank)
            self._carry = int(preds[cut_f - 1]) if cut_f > 0 else self._carry
            self._buffer = self._buffer[cut_f * self.FRAME_SAMPLES:]
            preds = preds[cut_f:]
        return preds

    def _text(self) -> str:
        return decode_text(self.decoder, self._committed + self._fresh)

    # --------------------------------------------------------------- API
    def push(self, pcm: np.ndarray) -> dict:
        """Ingest a chunk of float PCM; return the current partial result."""
        if self._finished:
            raise RuntimeError("push() after finish()")
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        if self.window is not None and len(pcm) > self.hop:
            # windowed mode: a giant push goes hop by hop, so the encoder
            # never sees more than window + hop samples (the bucket set
            # stays at most _bucket(window + hop), memory O(window))
            out = None
            for s in range(0, len(pcm), self.hop):
                out = self.push(pcm[s: s + self.hop])
            return out
        self._buffer = np.concatenate([self._buffer, pcm])
        self._pending += len(pcm)
        if (self.window is None and not self._warned_unbounded
                and len(self._buffer) > self.UNBOUNDED_WARN_SECONDS
                * self.SAMPLE_RATE):
            # unbounded mode re-runs the whole forward every hop: exact,
            # but a stream's device cost grows as O(T^2)
            logging.getLogger(__name__).warning(
                "unbounded stream passed %d s buffered; per-push cost grows "
                "with the whole stream (O(T^2) cumulative). Set "
                "window_seconds for bounded cost, or use the causal encoder "
                "+ CausalStreamingTranscriber for exact O(chunk) streaming.",
                self.UNBOUNDED_WARN_SECONDS)
            self._warned_unbounded = True
        if (self._pending >= self.hop
                and len(self._buffer) >= self.FRAME_SAMPLES):
            self._pending = 0
            preds = self._slide_window(self._forward_preds(self._buffer))
            self._fresh = _collapse_host(preds, self.blank, prev=self._carry)
        return {"text": self._text(), "final": False,
                "buffered_seconds": len(self._buffer) / self.SAMPLE_RATE}

    def finish(self) -> dict:
        """Flush: one last forward over the remaining buffer; final text."""
        if not self._finished:
            if len(self._buffer) >= self.FRAME_SAMPLES:
                preds = self._slide_window(self._forward_preds(self._buffer))
                self._fresh = _collapse_host(preds, self.blank,
                                             prev=self._carry)
            self._finished = True
        return {"text": self._text(), "final": True,
                "device_seconds": self.device_seconds}
