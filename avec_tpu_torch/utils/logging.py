"""Scalar logging without TensorBoard (port of avec_tpu/utils/logging.py).

The training engine logs to TensorBoard's `SummaryWriter` where it imports
(the reference's nnet/model.py:596-616); without it, to an append-only JSON
lines file of the same (tag, value, step) records: `JsonlWriter`. Its
records are the JAX package's, key for key.
"""

import json
import time


class JsonlWriter:
    """The subset of `SummaryWriter` the engine calls, writing JSON lines."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def add_scalar(self, tag: str, value: float, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step) if step is not None
                                  else None,
                                  "ts": time.time()}) + "\n")
        self._f.flush()

    def add_text(self, tag: str, text: str, step=None):
        self._f.write(json.dumps({"tag": tag, "text": text,
                                  "step": step, "ts": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
