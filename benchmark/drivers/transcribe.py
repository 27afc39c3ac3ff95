"""Closed-loop transcription of files: the port's batching loop
`serve.stdin_loop` reads 16-bit wav paths from a feed that keeps
`outstanding` requests open, and its JSON results go to a sink that frees a
slot for each. The files are a pool with lengths evenly spread over the
traffic's range and contents from a fixed seed, written once into the
checkout's `build/bench_wavs/` and read from there by every run; the run's
seed orders the pool. Set-up serves `warmup_requests` through the same
loop; the window feeds paths for `seconds` and counts the audio seconds of
the results that returned inside it. What depends on the model comes
from `cell.family`.
"""

import hashlib
import json
import os
import shutil
import threading
import time
import wave

import numpy as np
import torch

from benchmark import costs, data, harness, served


_POOL_SEED = 20211                # the files' contents, the same for all seeds
_POOL_VERSION = 1


class Feed:
    """The loop's input: path lines while fewer than `outstanding` results
    are due, until `stop` is set or `limit` lines were given."""

    def __init__(self, paths, order, outstanding: int, limit=None):
        self.paths, self.order = paths, order
        self.outstanding, self.limit = outstanding, limit
        self.cond = threading.Condition()
        self.open, self.sent, self.stop = 0, 0, False

    def __iter__(self):
        return self

    def __next__(self):
        with self.cond:
            while self.open >= self.outstanding and not self.stop:
                self.cond.wait()
            if self.stop or (self.limit is not None
                             and self.sent >= self.limit):
                raise StopIteration
            path = self.paths[self.order[self.sent % len(self.order)]]
            self.sent += 1
            self.open += 1
            return path + "\n"

    def done(self):
        with self.cond:
            self.open -= 1
            self.cond.notify()


class Sink:
    """The loop's output: one JSON result a line."""

    def __init__(self, feed: Feed):
        self.feed, self.buf, self.results = feed, "", []

    def write(self, s):
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            if line.strip():
                self.results.append((time.perf_counter(), json.loads(line)))
                self.feed.done()

    def flush(self):
        pass


class Driver:
    def __init__(self, cell, seed: int, device, root: str):
        from avec_tpu_torch.serve import stdin_loop

        cfg, tr = cell.config, cell.traffic
        self.spec, self.tr, self.device = cfg["model"], tr, device
        self.stdin_loop = stdin_loop
        self.family = cell.family
        model, state = self.family.build_model(
            self.spec, cfg["serve"]["route"], data.torch_seed(seed, 0), device)
        names = {n for n, _ in model.named_parameters()}
        self.P = {k: v for k, v in state.items() if k in names}
        self.B = {k: v for k, v in state.items() if k not in names}
        self.srv = self.family.server(model, cfg["serve"], self.spec, device)
        self.calls = self.family.kernel_calls(model, training=False)
        self.capture = served.Capture(self.srv, seed, self.family)
        n = tr["files"]
        self.samples = np.sort(data.utterance_samples(tr, n, 0))
        self.paths = self._pool(root, self.samples)
        self.seconds_of = {p: s / data.SR
                           for p, s in zip(self.paths, self.samples)}
        self.order = data.rng(seed, 6).permutation(n)
        self._loop(Feed(self.paths, self.order, tr["outstanding"],
                        limit=tr["warmup_requests"]))
        self.start = tr["warmup_requests"]

    def _pool(self, root, samples):
        """The pool's paths, written on first use (into a staging directory
        renamed into place, so that a run cut short leaves no half pool)."""
        key = hashlib.sha256(json.dumps(
            [_POOL_VERSION, samples.tolist()]).encode()).hexdigest()[:16]
        base = os.path.join(root, "build", "bench_wavs")
        final = os.path.join(base, key)
        paths = [os.path.join(final, f"utt{i:05d}.wav")
                 for i in range(len(samples))]
        if os.path.isdir(final):
            return paths
        stage = final + ".partial"
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        for i in range(0, len(samples), 128):
            s = samples[i:i + 128]
            x = data.audio(s, _POOL_SEED + i, self.device)
            pcm = (x.clamp(-1, 1) * 32767).round().to(torch.int16).cpu()
            for j, k in enumerate(s):
                path = os.path.join(stage, f"utt{i + j:05d}.wav")
                with wave.open(path, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(data.SR)
                    w.writeframes(pcm[j, :k].numpy().tobytes())
        os.rename(stage, final)
        return paths

    def _loop(self, feed, seconds=None):
        sink = Sink(feed)
        if seconds is not None:
            timer = threading.Timer(seconds, self._stop, (feed,))
            timer.start()
        self.stdin_loop(self.srv, max_batch=self.tr["max_batch"],
                        window_ms=self.tr["window_ms"], out=sink,
                        stream=feed)
        return sink

    @staticmethod
    def _stop(feed):
        with feed.cond:
            feed.stop = True
            feed.cond.notify_all()

    def window(self, seconds: float) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        order = np.roll(self.order, -(self.start % len(self.order)))
        feed = Feed(self.paths, order, self.tr["outstanding"])
        self.capture.recording = self.capture.timing = True
        t0 = time.perf_counter()
        sink = self._loop(feed, seconds)
        self.capture.recording = self.capture.timing = False
        end = t0 + seconds
        inside = [r for t, r in sink.results if t <= end]
        audio_s = sum(self.seconds_of[r["file"]] for r in inside
                      if "error" not in r)
        self.failed = sum("error" in r for _, r in sink.results)
        self.attempted = len(sink.results)
        self.start += feed.sent
        self.window_info = {
            "window_s": seconds, "submit_ms": list(self.capture.submit_ms),
            "batch_rows": list(self.capture.batch_rows),
            "flops": sum(self.family.forward_flops(self.spec, *shape)
                         for shape in self.capture.shapes)}
        return {"transcribe_audio_s_per_s": audio_s / seconds}

    def counts(self):
        return self.attempted, self.failed

    def slice(self):
        order = np.roll(self.order, -(self.start % len(self.order)))
        feed = Feed(self.paths, order, self.tr["outstanding"])
        self.calls.calls, self.calls.active = [], True
        self._loop(feed, self.tr["trace_seconds"])
        self.start += feed.sent
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.calls.active = False

    def layer_ctx(self, summary) -> dict:
        return {"kind": "serve", "window": self.window_info,
                "trace": summary,
                "kernel_bound_s": costs.kernel_bounds(self.calls.calls)}

    def release_program(self):
        self.calls.remove()
        self.capture.restore()
        self.srv = self.calls = None
        harness.release()

    def _inputs_of(self, c):
        from benchmark.reference.wav import read_wav

        return self.family.reference_inputs({"audio": read_wav(c["item"])},
                                            c["shape"], self.device)

    def check(self) -> dict:
        return served.check(self.family.reference_forward, self.spec,
                            self.P, self.B, self.capture.rows,
                            self._inputs_of)

    def control(self, fault: str = "fp8") -> dict:
        return served.control(self.family.reference_forward, self.spec,
                              self.P, self.B, self.capture.rows,
                              self._inputs_of)
