"""Open-loop serving of the family's requests through `Server.submit_batch`
/ `finish_batch`: requests fall due at a fixed Poisson rate (`rate` a
second; the gaps at the quantiles of the exponential law, in a seeded
order) whether or not the server keeps up,
and are batched by a frozen copy of the rule of `serve.stdin_loop` (block
on the first request, gather more for up to `window_ms`, at most
`max_batch`; batch N is submitted before batch N-1 is finished; an empty
queue finishes the pending batch at once). A request's latency runs from
the time it fell due to the return of the `finish_batch` that holds it.
The requests are a pool made at set-up on the host (lengths evenly spread
over the traffic's range), replayed in a seeded order. Set-up serves
`warmup_seconds` at the cell's rate. What depends on the model comes
from `cell.family`.
"""

import queue
import threading
import time

import numpy as np
import torch

from benchmark import costs, data, harness, served



class Driver:
    def __init__(self, cell, seed: int, device, root: str):
        cfg, tr = cell.config, cell.traffic
        self.spec, self.tr, self.device = cfg["model"], tr, device
        self.rate = tr["rate"]
        self.family = cell.family
        model, state = self.family.build_model(
            self.spec, cfg["serve"]["route"], data.torch_seed(seed, 0), device)
        names = {n for n, _ in model.named_parameters()}
        self.P = {k: v for k, v in state.items() if k in names}
        self.B = {k: v for k, v in state.items() if k not in names}
        self.srv = self.family.server(model, cfg["serve"], self.spec, device)
        self.calls = self.family.kernel_calls(model, training=False)
        self.capture = served.Capture(self.srv, seed, self.family)
        self.seed = seed
        self.pool = self._pool(tr["pool"], seed)
        self.order = data.rng(seed, 6).permutation(len(self.pool))
        self.served = 0
        self._run(tr["warmup_seconds"], seed + 1)

    def _pool(self, n, seed):
        samples = data.utterance_samples(self.tr, n, seed)
        pool = []
        for i in range(0, n, 16):
            pool += self.family.requests(self.spec, samples[i:i + 16],
                                         seed * 4096 + i, self.device)
        return pool

    def _run(self, seconds: float, seed: int) -> dict:
        """Serve the arrivals due in `seconds` and every request they hold;
        per request its due time, finish time and result."""
        n = max(1, int(round(self.rate * seconds)))
        gaps = data.arrival_gaps(self.rate, n, seed)
        q: "queue.Queue" = queue.Queue()
        due_at, late = [], []
        t0 = time.perf_counter() + 0.05
        offsets = np.cumsum(gaps) - gaps[0]

        def generate():
            for i, off in enumerate(offsets):
                if off > seconds:
                    break
                due = t0 + off
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                late.append(time.perf_counter() - due)
                q.put((i, due))
            q.put(None)

        gen = threading.Thread(target=generate, daemon=True)
        gen.start()
        done, spans, pending, open_at = {}, [], None, None
        first = self.served

        def finish(p):
            res = self.srv.finish_batch(p["handle"])
            t = time.perf_counter()
            spans.append((p["start"], t))
            for (i, due), r in zip(p["reqs"], res):
                done[i] = (due, t, r)

        eof = False
        while not eof:
            item = q.get()
            if item is None:
                break
            batch = [item]
            deadline = time.perf_counter() + self.tr["window_ms"] / 1e3
            while len(batch) < self.tr["max_batch"]:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    eof = True
                    break
                batch.append(nxt)
            reqs = [self.pool[self.order[(first + i) % len(self.pool)]]
                    for i, _ in batch]
            start = time.perf_counter()
            handle = self.srv.submit_batch(reqs, [d for _, d in batch])
            submitted = {"handle": handle, "reqs": batch, "start": start}
            if pending is not None:
                finish(pending)
            pending = submitted
            if eof or q.empty():
                finish(pending)
                pending = None
        if pending is not None:
            finish(pending)
        gen.join()
        self.served += len(offsets)
        return {"done": done, "due": len(late), "late": late,
                "spans": spans, "t0": t0}

    def window(self, seconds: float) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.capture.recording = self.capture.timing = True
        out = self._run(seconds, self.seed)
        self.capture.recording = self.capture.timing = False
        lat = [(t - due) for due, t, r in out["done"].values()
               if "error" not in r]
        self.attempted = out["due"]
        self.failed = out["due"] - len(lat)
        lat += [float("inf")] * self.failed
        lat.sort()
        p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
        union = sum(e - s for s, e in _merge(out["spans"]))
        late = sorted(out["late"])
        print(f"generator lateness over {len(late)} arrivals: median "
              f"{1e3 * late[len(late) // 2]:.3f} ms, max "
              f"{1e3 * late[-1]:.3f} ms", flush=True)
        self.window_info = {
            "window_s": seconds, "busy_s": union,
            "submit_ms": list(self.capture.submit_ms),
            "batch_rows": list(self.capture.batch_rows),
            "flops": sum(self.family.forward_flops(self.spec, *shape)
                         for shape in self.capture.shapes),
            "p50_ms": 1e3 * lat[len(lat) // 2]}
        return {"serve_p95_ms": 1e3 * p95}

    def counts(self):
        return self.attempted, self.failed

    def slice(self):
        self.calls.calls, self.calls.active = [], True
        self._run(self.tr["trace_seconds"], self.seed + 2)
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
        return self.family.reference_inputs(c["item"], c["shape"],
                                            self.device)

    def check(self) -> dict:
        return served.check(self.family.reference_forward, self.spec,
                            self.P, self.B, self.capture.rows,
                            self._inputs_of)

    def control(self, fault: str = "fp8") -> dict:
        return served.control(self.family.reference_forward, self.spec,
                              self.P, self.B, self.capture.rows,
                              self._inputs_of)


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
