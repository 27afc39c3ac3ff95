"""Batched and streaming serving of the Efficient Conformer models (port of
tools/serve.py), in the modes of tools/serve.py:72-90: "av" the
audio-visual model, "ao" the audio-only model (`causal` for its causal
variant), "vo" the video-only model.

    python -m avec_tpu_torch.serve --mode ao [--checkpoint ckpt.ckpt] \
        [--tokenizer tok.json] a.wav b.flac
    ... --stdin --max_batch 8 --batch_window_ms 50   # serve stdin until EOF
    ... --mode av clip.mp4        # expects clip.wav next to the video
    ... --stream [--causal] --chunk_ms 480 a.wav      # live partials

A request is a path (wav or flac audio; anything else a mouth-crop video
read by `demo.load_av_inputs`, with the .wav beside it, which needs OpenCV)
or a dict of arrays, {"video": (Tv, 88, 88, 1) float32 frames at 25 fps,
"audio": (Ta,) float32 samples at 16 kHz}, with what the mode reads. A
batch of requests is padded to a power-of-two length bucket (in audio
samples; a video frame counts 640) and batch bucket, run through one
forward, and collapsed greedily on the device, or decoded by a beam decoder
(`decode/beam.py`'s on the host, `decode/device_beam.py`'s on the card),
which sees the real rows only. Padding is masked by the model's length
semantics, so neither bucket nor batch padding changes a transcription.

`submit_batch` launches a batch's device work and returns at once (the
inputs go to the card through pinned memory without a wait); `finish_batch`
fetches and decodes it. `stdin_loop` keeps a one-deep pipeline: batch N is
submitted before batch N-1 is decoded. `stream_file` feeds a wav through
`decode/streaming.py` (bidirectional models: the forward re-run over the
buffer) or `decode/causal_streaming.py` (the causal model: exact O(chunk)
steps with carried state).
"""

import argparse
import json
import os
import queue
import sys
import threading
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
_MODE_INPUTS = {"av": ("video", "audio"), "ao": ("audio",), "vo": ("video",)}


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
    """Serving loop: bucket -> forward -> greedy collapse or beam search.

    model_kwargs go to the zoo model of `mode` (defaults: the reference
    depth, vocab 256; mode "ao" without InterCTC blocks, as tools/serve.py
    builds it; `causal` builds the causal AO model with `left_context`).
    `checkpoint`: a torch-format file or a JAX package's msgpack file
    (`train/checkpoint.py`) whose model weights are loaded. The activations run in `precision` (bf16 by
    default, as tools/serve.py); parameters stay fp32.

    `tokenizer`: a tokenizer path; where the file exists, results carry
    text, else greedy results carry token ids ("tokens") and "text" None.
    `decoder`: "greedy" (None), "beam" (`CTCBeamSearchDecoder` on the
    tokenizer with `decoder_kwargs`: beam_size, ngram_path, ngram_alpha,
    ngram_beta, ngram_tmp, neural_config_path, neural_checkpoint, ...), or
    a beam decoder object (`CTCBeamSearchDecoder`,
    `CTCDeviceBeamSearchDecoder`)."""

    # Batch-padding rows: zero audio/video with this many valid samples, so
    # every mask row has real frames (no all-masked attention).
    PAD_ROW_SAMPLES = 2560

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 device="cuda", precision: str = "bfloat16", seed: int = 0,
                 mode: str = "av", decoder="greedy",
                 tokenizer: Optional[str] = None,
                 checkpoint: Optional[str] = None,
                 decoder_kwargs: Optional[Dict] = None, causal: bool = False,
                 left_context: int = 128, **model_kwargs):
        if mode not in _MODELS:
            raise ValueError(f"mode {mode!r} not in {sorted(_MODELS)}")
        if causal and mode != "ao":
            raise ValueError("causal is audio-only (mode 'ao')")
        self.mode = mode
        self.device = resolve_device(device)
        self.precision = precision
        self.dtype = _DTYPES[precision]
        if model is None:
            if mode == "ao":
                model_kwargs.setdefault("interctc_blocks", ())
            if causal:
                model_kwargs.update(causal=True, left_context=left_context)
            model = _MODELS[mode](
                device=self.device,
                generator=torch.Generator().manual_seed(seed), **model_kwargs)
        self.model = model
        self.causal = bool(getattr(model.encoder, "causal", False))
        self.checkpoint = checkpoint
        if checkpoint:
            if not os.path.isfile(checkpoint):
                raise FileNotFoundError(checkpoint)
            from avec_tpu_torch.train.checkpoint import load_checkpoint

            model.load_state_dict(load_checkpoint(checkpoint)
                                  ["model_state_dict"], strict=True)
        tok = tokenizer if tokenizer and os.path.isfile(tokenizer) else None
        self.decoder = CTCGreedySearchDecoder(tok)
        self.beam_decoder = None
        if decoder == "beam":
            if tok is None:
                raise FileNotFoundError(f"the beam decoder needs a tokenizer; "
                                        f"{tokenizer!r} is not a file")
            from avec_tpu_torch.decode.beam import CTCBeamSearchDecoder

            self.beam_decoder = CTCBeamSearchDecoder(
                tok, **{"device": self.device, **(decoder_kwargs or {})})
        elif decoder not in (None, "greedy"):
            if isinstance(decoder, str):
                raise ValueError(f"decoder {decoder!r}: 'greedy' or 'beam'")
            self.beam_decoder = decoder
        self._buckets = set()   # (batch bucket, length bucket) shapes served
        self.latencies: List[float] = []
        self.rtfs: List[float] = []

    # ------------------------------------------------------------ inputs
    def load_request(self, path: str) -> Dict[str, np.ndarray]:
        """A path -> the request's arrays: wav / flac audio at 16 kHz, or a
        video (`demo.load_av_inputs`) with the .wav beside it if any."""
        from avec_tpu_torch.utils import media

        if path.endswith(".wav") or path.endswith(".flac"):
            audio, sr = media.read_audio(path)
            if sr != 16000:
                audio = media.resample_audio(audio, sr, 16000)
            return {"audio": audio.astype(np.float32)}
        from avec_tpu_torch.demo import load_av_inputs

        video, audio, _ = load_av_inputs(path)
        out = {"video": video.astype(np.float32)}
        if audio is not None:
            out["audio"] = audio.astype(np.float32)
        return out

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the device's
        queue: through pinned memory, asynchronously, on the card."""
        t = torch.as_tensor(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def forward(self, inputs, dtype: Optional[torch.dtype] = None):
        """Padded numpy inputs -> (logits, lengths) on the device. Float
        inputs are cast to the activation dtype."""
        dtype = dtype or self.dtype
        args = []
        for a in inputs:
            t = self._to_device(a)
            args.append(t.to(dtype) if t.is_floating_point() else t)
        return self.model(*args)["outputs"]

    # ------------------------------------------------------- transcription
    def submit_batch(self, items, enqueue_times=None) -> Dict:
        """Load a batch (paths or request dicts) and launch its device
        work; return the pending handle for `finish_batch`. A path that
        fails to load, or a request without the mode's inputs, becomes a
        {"file", "error"} result; the other requests still run."""
        if enqueue_times is None:
            enqueue_times = [time.perf_counter()] * len(items)
        reqs, order, results = [], [], [None] * len(items)
        for i, item in enumerate(items):
            try:
                req = self.load_request(item) if isinstance(item, str) else item
                missing = [k for k in _MODE_INPUTS[self.mode] if k not in req]
                if missing:
                    raise ValueError(f"mode {self.mode!r} needs {missing}")
                reqs.append(req)
                order.append(i)
            except Exception as e:  # keep serving the rest
                results[i] = ({"file": item, "error": str(e)}
                              if isinstance(item, str) else {"error": str(e)})
        pending = {"items": items, "times": enqueue_times, "order": order,
                   "results": results, "n": len(reqs), "pre": None,
                   "samples": []}
        if reqs:
            samples = [self._request_samples(r) for r in reqs]
            shape = (_batch_bucket(len(reqs)), _bucket(max(samples)))
            self._buckets.add(shape)
            logits, lengths = self.forward(
                self._inputs_for_batch(reqs, shape[1], shape[0]))
            pending["samples"] = samples
            n = len(reqs)
            if self.beam_decoder is not None:
                pending["pre"] = self.beam_decoder.device_fn((logits[:n],
                                                              lengths[:n]))
            else:
                pending["pre"] = self.decoder.device_fn((logits, lengths))
        return pending

    def finish_batch(self, pending: Dict) -> List[Dict]:
        """Fetch a submitted batch's outputs and decode its real rows; one
        result per item, in order."""
        n, results = pending["n"], pending["results"]
        if n:
            tokens = None
            if self.beam_decoder is not None:
                texts = self.beam_decoder(pending["pre"])
            else:
                toks, tok_lens = pending["pre"]
                out = self.decoder((toks[:n], tok_lens[:n]))
                if self.decoder.tokenizer is None:
                    texts, tokens = [None] * n, out
                else:
                    texts = out
            done = time.perf_counter()
            for k, i in enumerate(pending["order"]):
                dt = done - pending["times"][i]
                rtf = dt / max(pending["samples"][k] / 16000.0, 1e-6)
                self.latencies.append(dt)
                self.rtfs.append(rtf)
                item = pending["items"][i]
                row = {"file": item} if isinstance(item, str) else {}
                row["text"] = texts[k]
                if tokens is not None:
                    row["tokens"] = tokens[k]
                row.update(latency_s=round(dt, 4), rtf=round(rtf, 5),
                           batch_size=n, compiled_buckets=len(self._buckets))
                results[i] = row
        return results

    def transcribe_batch(self, items, enqueue_times=None) -> List[Dict]:
        """Serve paths or request dicts as one device batch. Latency runs
        from enqueue_times[i] (default: now) to the moment the result is
        ready: queue wait, loading, device time and decoding."""
        return self.finish_batch(self.submit_batch(items, enqueue_times))

    def transcribe(self, path: str) -> Dict:
        return self.transcribe_batch([path])[0]

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
                "rtf_mean": float(np.mean(self.rtfs)),
                "compiled_buckets": len(self._buckets)}


def stdin_loop(srv: Server, max_batch: int = 8, window_ms: float = 50.0,
               out=None, stream=None) -> None:
    """Batching request loop over `stream` (default sys.stdin), one path
    per line, one JSON result per line to `out` (default sys.stdout): block
    on the first pending path, then linger up to window_ms gathering more
    (at most max_batch) before running one device batch.

    One-deep pipeline: batch N is submitted before batch N-1's host decode
    runs, so the decode overlaps the device's work on N. When the queue is
    empty the pending batch is finished at once."""
    out = sys.stdout if out is None else out
    stream = sys.stdin if stream is None else stream
    q = queue.Queue()
    eof_mark = object()

    def reader():
        for line in stream:
            if line.strip():
                q.put((line.strip(), time.perf_counter()))
        q.put((eof_mark, None))

    threading.Thread(target=reader, daemon=True).start()
    pending = None

    def emit(batch_pending):
        for r in srv.finish_batch(batch_pending):
            print(json.dumps(r), file=out, flush=True)

    while True:
        path, t0 = q.get()
        if path is eof_mark:
            break
        batch, times = [path], [t0]
        deadline = time.perf_counter() + window_ms / 1000.0
        eof = False
        while len(batch) < max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                p, t = q.get(timeout=remaining)
            except queue.Empty:
                break
            if p is eof_mark:
                eof = True
                break
            batch.append(p)
            times.append(t)
        submitted = srv.submit_batch(batch, times)   # the device starts now
        if pending is not None:
            emit(pending)       # host decode overlaps the running batch
        pending = submitted
        if eof or q.empty():
            emit(pending)
            pending = None
        if eof:
            break
    if pending is not None:
        emit(pending)


def stream_file(srv: Server, path: str, chunk_ms: float = 480.0,
                window_s: float = 0.0, out=None) -> Dict:
    """A simulated live stream: the file's audio in chunk_ms slices through
    `CausalStreamingTranscriber` (a causal model: every token final) or
    `StreamingTranscriber` (window_s > 0: a bounded window), one JSON line
    per changed partial and a final line to `out` (default sys.stdout).
    Returns the final result."""
    out = sys.stdout if out is None else out
    audio = srv.load_request(path)["audio"]
    if srv.causal:
        from avec_tpu_torch.decode.causal_streaming import \
            CausalStreamingTranscriber

        st = CausalStreamingTranscriber(srv.model, srv.decoder,
                                        precision=srv.precision)
    else:
        from avec_tpu_torch.decode.streaming import StreamingTranscriber

        st = StreamingTranscriber(srv.model, srv.decoder,
                                  window_seconds=window_s or None,
                                  precision=srv.precision)
    step = max(1, int(chunk_ms * 16))
    last = None
    for start in range(0, len(audio), step):
        r = st.push(audio[start: start + step])
        if r["text"] != last:
            last = r["text"]
            print(json.dumps({"file": path, "partial": r["text"],
                              "t": round((start + step) / 16000.0, 2)}),
                  file=out, flush=True)
    final = st.finish()
    print(json.dumps({"file": path, "text": final["text"], "final": True,
                      "device_seconds": round(final["device_seconds"], 4)}),
          file=out, flush=True)
    return final


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--mode", choices=["ao", "vo", "av"], default="ao")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--tokenizer",
                    default="datasets/LRS3/tokenizerbpe256.json")
    ap.add_argument("--decoder", choices=["greedy", "beam"], default="greedy")
    ap.add_argument("--beam_size", type=int, default=16)
    ap.add_argument("--ngram", default=None,
                    help="ARPA n-gram LM path for --decoder beam")
    ap.add_argument("--ngram_alpha", type=float, default=0.6)
    ap.add_argument("--ngram_beta", type=float, default=1.0)
    ap.add_argument("--ngram_tmp", type=float, default=1.0)
    ap.add_argument("--neural_config", default=None,
                    help="LM config module for GPT beam rescoring")
    ap.add_argument("--neural_checkpoint", default=None,
                    help="LM checkpoint filename inside the config's "
                         "callback_path")
    ap.add_argument("--stdin", action="store_true",
                    help="serve request paths from stdin, one per line")
    ap.add_argument("--max_batch", type=int, default=8,
                    help="max requests batched into one device call")
    ap.add_argument("--batch_window_ms", type=float, default=50.0,
                    help="linger window for gathering a batch from stdin")
    ap.add_argument("--stream", action="store_true",
                    help="audio-only: stream each wav in chunks, printing "
                         "partial transcripts then a final one")
    ap.add_argument("--chunk_ms", type=float, default=480.0,
                    help="--stream chunk size in milliseconds")
    ap.add_argument("--stream_window_s", type=float, default=0.0,
                    help="--stream bounded audio window (0 = unbounded)")
    ap.add_argument("--causal", action="store_true",
                    help="audio-only: use the causal encoder variant; "
                         "--stream then runs exact O(chunk) cached-state "
                         "streaming (requires a causal-trained checkpoint)")
    ap.add_argument("--left_context", type=int, default=128,
                    help="causal attention history bound (stage-1 frames)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu' (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.stream and args.mode != "ao":
        ap.error("--stream is audio-only (use --mode ao)")
    if args.stream and not args.paths:
        ap.error("--stream requires at least one wav path")
    if (args.ngram or args.neural_config) and args.decoder != "beam":
        ap.error("--ngram/--neural_config require --decoder beam")
    if args.causal and args.mode != "ao":
        ap.error("--causal is audio-only (use --mode ao)")
    if args.decoder == "beam" and not os.path.isfile(args.tokenizer):
        ap.error(f"--decoder beam needs a tokenizer: {args.tokenizer} is "
                 "not a file")

    decoder_kwargs = {}
    if args.decoder == "beam":
        decoder_kwargs = dict(beam_size=args.beam_size,
                              ngram_path=args.ngram,
                              ngram_alpha=args.ngram_alpha,
                              ngram_beta=args.ngram_beta,
                              ngram_tmp=args.ngram_tmp,
                              neural_config_path=args.neural_config,
                              neural_checkpoint=args.neural_checkpoint)
    # the port's serving kernels: flash attention in the RelPos1d layers,
    # the fused video stem
    kernels = {"ao": dict(use_flash=not args.causal),
               "vo": dict(stem_mode="pallas"),
               "av": dict(use_flash=True, stem_mode="pallas")}[args.mode]
    srv = Server(mode=args.mode, device=args.device,
                 checkpoint=args.checkpoint, tokenizer=args.tokenizer,
                 decoder=args.decoder, decoder_kwargs=decoder_kwargs,
                 causal=args.causal, left_context=args.left_context,
                 **kernels)
    if not args.checkpoint:
        print("WARNING: no checkpoint — transcriptions will be noise",
              file=sys.stderr)

    if args.stream:
        for path in args.paths:
            stream_file(srv, path, args.chunk_ms, args.stream_window_s)
    elif args.paths:
        for r in srv.transcribe_batch(list(args.paths)):
            print(json.dumps(r), flush=True)
    if args.stdin:
        stdin_loop(srv, args.max_batch, args.batch_window_ms)
    print(json.dumps({"summary": srv.stats_summary()}), file=sys.stderr,
          flush=True)


if __name__ == "__main__":
    main()
