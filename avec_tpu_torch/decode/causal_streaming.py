"""Exact O(chunk) streaming transcription for the causal audio model (port
of avec_tpu/decode/causal_streaming.py).

`StreamingTranscriber` (decode/streaming.py) re-runs the whole forward over
the buffered audio at every push. With `AudioEfficientConformerInterCTC(
causal=True, left_context=L)` every output frame is a function of past
audio alone, so this transcriber runs the encoder chunk by chunk with
carried state and never revisits a frame:

  * fbank: each chunk's analysis windows are sliced from the raw-sample
    buffer (frame f covers x[f*hop - 256, f*hop + 256), torch.stft's
    center=True), reflect padding only at the stream's start and at
    `finish`;
  * the conv stem and the depthwise convs: (k - 1)-frame input tails take
    the place of the causal left zero padding;
  * attention: right-aligned key/value caches of L >> stage keys per layer,
    the slots not yet filled masked during warm-up. The offline model's
    mask restriding halves the left context per stage, so caches of
    L >> s keys give the offline band exactly.

Every emitted token is final (the model is causal), so the partial is the
committed transcript and a push costs O(chunk * L) on the device. The
concatenated logits equal the offline `causal=True` forward of the whole
utterance up to the reassociation of sums, and the transcript is the same.

The step runs under `torch.inference_mode()` on the model's device, in the
serving dtype (`precision`); it launches no hand-written kernel (the causal
encoder's attention is Transformer-XL, the flash kernel is RelPos1d's).
"""

import time
from typing import List, Optional

import numpy as np
import torch

from avec_tpu_torch.decode.streaming import DTYPES, decode_text

__all__ = ["CausalStreamingTranscriber"]

HOP = 160          # fbank hop (10 ms at 16 kHz)
N_FFT = 512
PAD = N_FFT // 2   # center-padding lookahead per frame
STRIDES = 8        # fbank frames per 12.5 Hz output frame (2*2*2)

def _od(n: int) -> int:
    """Length update of one causal stride-2 layer: (n-1)//2 + 1."""
    return (n - 1) // 2 + 1


class CausalStreamingTranscriber:
    """Chunked exact streaming for a causal audio model.

    model: `AudioEfficientConformerInterCTC(causal=True, left_context=L)`
    (L a multiple of 4; None reads as 128), with its weights; the
    transcriber puts it in eval mode. decoder:
    `CTCGreedySearchDecoder` (tokenizer and blank id). chunk_frames: fbank
    frames per device step, a multiple of 8. precision: "float32" (None)
    or "bfloat16", the activations' dtype; parameters stay fp32."""

    def __init__(self, model, decoder, chunk_frames: int = 16,
                 precision: Optional[str] = None):
        net = model.encoder
        if not getattr(net, "causal", False):
            raise ValueError("CausalStreamingTranscriber needs a causal=True "
                             "model")
        self.left_context = int(net.left_context or 128)
        if self.left_context % 4:
            raise ValueError("left_context must be a multiple of 4")
        if chunk_frames <= 0 or chunk_frames % STRIDES:
            raise ValueError(f"chunk_frames must be a positive multiple of "
                             f"{STRIDES}")
        # eval mode: batch norm on its running statistics, no dropout
        self.model = model.eval()
        self.decoder = decoder
        self.blank = getattr(decoder, "blank_token", 0)
        self.chunk = chunk_frames
        self.precision = precision
        self.dtype = DTYPES[precision]
        self.device = next(model.parameters()).device

        self._buffer = np.zeros((0,), np.float32)
        self._f_done = 0          # fbank frames fully processed
        self._tokens: List[int] = []
        self._prev = self.blank   # greedy-collapse carry
        self._o_done = 0          # output (12.5 Hz) frames emitted
        self._finished = False
        self._state = None
        self._masks = {}
        self.device_seconds = 0.0
        self.push_latencies: List[float] = []
        self.collect_logits = False      # exactness tests: keep chunk logits
        self.logits_chunks: List[np.ndarray] = []

    # ---------------------------------------------------------------- step
    def _build(self):
        """The zero state (caches of L >> stage keys) on the model's
        device, once per transcriber."""
        enc = self.model.encoder
        self._state = enc.stream_state(1, self.left_context, self.dtype,
                                       self.device)
        self._cache_len = [self.left_context >> p["stage_id"]
                           for p in enc.back_end.stream_plan()]

    def masks_for(self, p1: int):
        """Per-stage (1, 1, c_s, L_s + c_s) masks for a chunk that starts
        after p1 stage-1 frames: query i (key L_s + i) sees keys i .. L_s + i
        (the offline band of L_s past frames and itself) among the cache
        slots already filled, min(p1 >> s, L_s) from the right
        (causal_streaming.py:168-177). Cached per fill level."""
        L, c1 = self.left_context, self.chunk // 2
        valid = tuple(min(p1 >> s, L >> s) for s in range(3))
        if valid not in self._masks:
            masks = []
            for s in range(3):
                l_s, c_s = L >> s, c1 >> s
                i = torch.arange(c_s, device=self.device)[:, None]
                j = torch.arange(l_s + c_s, device=self.device)[None, :]
                m = (j >= i) & (j <= l_s + i) & (j >= l_s - valid[s])
                masks.append(m[None, None])
            self._masks[valid] = masks
        return self._masks[valid]

    def _step(self, xp: np.ndarray, p1: int):
        """One chunk: fbank of the padded window, the encoder's stream step,
        the caches trimmed back to L >> stage keys. Returns (argmax ids on
        the host, logits on the device)."""
        enc = self.model.encoder
        with torch.inference_mode():
            x = torch.from_numpy(xp).to(self.device)[None]
            fb = enc.preprocessing.stream_frames(x, self.chunk)
            logits, _, state = enc.stream_step(fb.to(self.dtype), self._state,
                                               self.masks_for(p1))
            for st, l_s in zip(state["blocks"], self._cache_len):
                st["att"] = {k: v[:, v.shape[1] - l_s:]
                             for k, v in st["att"].items()}
            self._state = state
            preds = torch.argmax(logits.float(), dim=-1)[0]
            return preds.cpu().numpy(), logits[0]

    # ------------------------------------------------------------ chunking
    def _window(self, f0: int, end_reflect: bool) -> np.ndarray:
        """Raw samples covering fbank frames [f0, f0+chunk): padded signal
        slice [f0*hop, (f0+chunk-1)*hop + n_fft), where padded = reflect(256)
        + x (+ reflect(256) at finish). Fixed length; zero-filled past the
        available signal (those frames are truncated by the caller)."""
        n = len(self._buffer)
        length = (self.chunk - 1) * HOP + N_FFT
        lo = f0 * HOP - PAD
        out = np.zeros((length,), np.float32)
        if lo < 0:                       # head reflection (stream start)
            head = self._buffer[1: 1 - lo][::-1]
            out[: len(head)] = head
            src_lo, dst = 0, -lo
        else:
            src_lo, dst = lo, 0
        take = self._buffer[src_lo: src_lo + (length - dst)]
        out[dst: dst + len(take)] = take
        if end_reflect:
            # the end reflection where the window runs past n:
            # x[n-2], x[n-3], ..., bounded by the signal
            tail_start = dst + len(take)
            need = length - tail_start
            if need > 0 and n >= 2:
                stop = max(-2 - need, -n - 1)
                refl = self._buffer[-2: stop: -1][:need]
                out[tail_start: tail_start + len(refl)] = refl
        return out

    def _run_block(self, f0: int, end_reflect: bool = False) -> np.ndarray:
        if self._state is None:
            self._build()
        xp = self._window(f0, end_reflect)
        t0 = time.perf_counter()
        preds, logits = self._step(xp, self._f_done // 2)
        if self.collect_logits:
            self.logits_chunks.append(logits.float().cpu().numpy())
        dt = time.perf_counter() - t0
        self.device_seconds += dt
        self.push_latencies.append(dt)
        self._f_done += self.chunk
        return preds

    def _emit(self, preds: np.ndarray):
        for p in preds.tolist():
            if p != self.blank and p != self._prev:
                self._tokens.append(int(p))
            self._prev = p
        self._o_done += len(preds)

    def _text(self) -> str:
        return decode_text(self.decoder, self._tokens)

    # ----------------------------------------------------------------- API
    def push(self, pcm: np.ndarray) -> dict:
        """Ingest PCM; run every complete chunk; return the partial, which
        is final for every emitted token (the model is causal)."""
        if self._finished:
            raise RuntimeError("push() after finish()")
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, pcm])
        n = len(self._buffer)
        # frames [f0, f0+F) need samples through (f0+F-1)*hop + 256
        while (self._f_done + self.chunk - 1) * HOP + PAD <= n:
            self._emit(self._run_block(self._f_done))
        return {"text": self._text(), "final": False,
                "committed_frames": self._o_done}

    def finish(self) -> dict:
        """Process the remaining frames (with the end reflection) and return
        the final transcript; the output-frame count is the offline
        forward's, od^3(T // hop + 1)."""
        if not self._finished:
            n = len(self._buffer)
            total_f = n // HOP + 1 if n else 0
            o_total = _od(_od(_od(total_f))) if total_f else 0
            while self._f_done < total_f:
                preds = self._run_block(self._f_done, end_reflect=True)
                keep = min(len(preds), o_total - self._o_done)
                self._emit(preds[:keep])
            self._finished = True
            self._o_total = o_total
        return {"text": self._text(), "final": True,
                "device_seconds": self.device_seconds}
