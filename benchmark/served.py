"""What the serving cells share: capturing the logits of the served batches
(by wrapping the server instance's `forward`), timing `submit_batch` on the
host, and the check of a sample of served requests against the reference.

Capture: of every batch whose index a seeded draw picks, the logits and
lengths of the longest request and of one more drawn row stay on the
device (no sync in the window) with the request's identity, the batch's
padded length and its position. After the window, each captured request
that returned is run alone through the reference's eval forward at that
padded length (the server pads a batch to one length bucket; a row's
result does not depend on the other rows), and two numbers are compared:

- logit_err: the widest relative error of a request's served logits over
  its valid output frames, |served - reference| / |reference| (Frobenius
  norms);
- tokens_off: requests whose returned token ids differ from the greedy
  CTC collapse (argmax, repeats merged, blanks dropped) of the served
  logits, by the benchmark's own rule.
"""

import time
from typing import List

import numpy as np

from benchmark.reference import train as ref_train


class Capture:
    def __init__(self, srv, seed: int, family, per_batch: int = 2,
                 share: float = 0.25):
        self.srv, self.family = srv, family
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 11])
        self.per_batch, self.share = per_batch, share
        self.rows: List[dict] = []
        self.submit_ms: List[float] = []
        self.batch_rows: List[int] = []
        self.shapes: List[tuple] = []
        self.recording = False
        self.timing = False
        self._items, self._batch, self._open = None, 0, {}
        self._forward, self._submit, self._finish = (
            srv.forward, srv.submit_batch, srv.finish_batch)
        srv.forward = self.forward
        srv.submit_batch = self.submit_batch
        srv.finish_batch = self.finish_batch

    def submit_batch(self, items, enqueue_times=None):
        self._batch += 1
        self._items = items
        t0 = time.perf_counter()
        pending = self._submit(items, enqueue_times)
        if self.timing:
            self.submit_ms.append((time.perf_counter() - t0) * 1e3)
            self.batch_rows.append(len(items))
        pending["bench_batch"] = self._batch
        return pending

    def finish_batch(self, pending):
        results = self._finish(pending)
        for row in self._open.pop(pending.get("bench_batch"), []):
            row["result"] = results[row["row"]]
        return results

    def forward(self, inputs, dtype=None):
        logits, lengths = self._forward(inputs, dtype)
        shape, row_len = self.family.served_batch(inputs)
        if self.timing:
            self.shapes.append(shape)
        if self.recording and self.rng.random() < self.share:
            n = len(self._items)
            rows = {int(np.argmax(np.asarray(row_len[:n])))}
            while len(rows) < min(self.per_batch, n):
                rows.add(int(self.rng.integers(n)))
            for r in sorted(rows):
                row = {"item": self._items[r], "row": r,
                       "logits": logits[r].detach().clone(),
                       "length": lengths[r].detach().clone(),
                       "shape": shape}
                self.rows.append(row)
                self._open.setdefault(self._batch, []).append(row)
        return logits, lengths

    def restore(self):
        self.srv.forward, self.srv.submit_batch, self.srv.finish_batch = (
            self._forward, self._submit, self._finish)


def collapse(ids: np.ndarray, blank: int = 0) -> List[int]:
    out, prev = [], None
    for t in ids.tolist():
        if t != prev and t != blank:
            out.append(int(t))
        prev = t
    return out


def check(forward, spec: dict, P, B, captured: List[dict], inputs_of,
          fp8: bool = False) -> dict:
    """`forward`: the family's plain reference; `inputs_of(row)`: the
    captured request's reference inputs at its batch's padded shape. A
    captured request without a result, or with an error, counts in
    tokens_off."""
    err, off, checked, frames = 0.0, 0, 0, 0
    for c in captured:
        res = c.get("result")
        if res is None or "error" in res:
            off += 1
            continue
        logits = c["logits"].float()
        n = int(c["length"])
        want, _ = ref_train.eval_logits(forward, spec, P, B, inputs_of(c),
                                        fp8=fp8)
        want = want[0, :n].float()
        served = logits[:n].argmax(dim=-1)
        err = max(err, float((logits[:n] - want).norm() / want.norm()))
        if collapse(served.cpu().numpy()) != list(res.get("tokens", [])):
            off += 1
        checked += 1
        frames += n
    return {"logit_err": err if checked else float("inf"),
            "tokens_off": off if checked else float("inf"),
            "checked": checked, "frames": frames}


def control(forward, spec: dict, P, B, captured: List[dict], inputs_of
            ) -> dict:
    """The control in the program's place: the float8 reference's logits
    of the captured requests against the reference's."""
    err = 0.0
    for c in captured:
        n = int(c["length"])
        inputs = inputs_of(c)
        want, _ = ref_train.eval_logits(forward, spec, P, B, inputs)
        low, _ = ref_train.eval_logits(forward, spec, P, B, inputs, fp8=True)
        want, low = want[0, :n].float(), low[0, :n].float()
        err = max(err, float((low - want).norm() / want.norm()))
    return {"logit_err": err if captured else float("inf")}
