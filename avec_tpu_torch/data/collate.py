"""Batch collation with per-field specs and length bucketing (port of
avec_tpu/data/collate.py:29-107).

A per-field spec {"axis": i, "padding": bool, "padding_value",
"start_token", "end_token"} maps sample-tuple indices to padded / stacked
inputs and targets (list, dict or tuple). Padded axes are rounded up to
buckets (`granularity` steps per power-of-two octave), so a loader yields
few distinct shapes; the true lengths travel separately.
"""

from typing import Any

import numpy as np


def round_to_bucket(n: int, granularity: int = 8) -> int:
    """Round n up to the next bucket boundary (granularity steps per octave)."""
    if n <= granularity:
        return max(n, 1)
    power = 1 << (n.bit_length() - 1)      # the largest power of two <= n
    if power == n:
        return n
    step = max(power // granularity, 1)
    return ((n + step - 1) // step) * step


class Collate:
    """Identity collate."""

    def __call__(self, samples):
        return samples


class CollateFn:
    """Samples -> {"inputs": ..., "targets": ...} by the field specs."""

    def __init__(self, inputs_params=None, targets_params=None,
                 bucket_granularity: int = 8):
        self.inputs_params = (inputs_params if inputs_params is not None
                              else [{"axis": 0}])
        self.targets_params = (targets_params if targets_params is not None
                               else [{"axis": 1}])
        self.bucket_granularity = bucket_granularity
        for params in self._iter_params(self.inputs_params):
            self._fill_defaults(params)
        for params in self._iter_params(self.targets_params):
            self._fill_defaults(params)

    @staticmethod
    def _iter_params(struct):
        return struct.values() if isinstance(struct, dict) else list(struct)

    @staticmethod
    def _fill_defaults(params):
        params.setdefault("padding", False)
        params.setdefault("padding_value", 0)
        params.setdefault("start_token", None)
        params.setdefault("end_token", None)

    def __call__(self, samples):
        return {"inputs": self.collate(samples, self.inputs_params),
                "targets": self.collate(samples, self.targets_params)}

    def _collate_field(self, samples, params):
        items = [np.asarray(s[params["axis"]]) for s in samples]
        if params["start_token"] is not None:
            items = [np.concatenate([np.full((1,), params["start_token"],
                                             dtype=it.dtype), it])
                     for it in items]
        if params["end_token"] is not None:
            items = [np.concatenate([it, np.full((1,), params["end_token"],
                                                 dtype=it.dtype)])
                     for it in items]
        if params["padding"]:
            max_len = max(it.shape[0] for it in items)
            if self.bucket_granularity:
                max_len = round_to_bucket(max_len, self.bucket_granularity)
            out = np.full((len(items), max_len) + items[0].shape[1:],
                          params["padding_value"], dtype=items[0].dtype)
            for i, it in enumerate(items):
                out[i, : it.shape[0]] = it
            return out
        return np.stack(items, axis=0)

    def collate(self, samples, collate_params):
        if isinstance(collate_params, dict):
            out: Any = {name: self._collate_field(samples, p)
                        for name, p in collate_params.items()}
            if len(out) == 1:
                return next(iter(out.values()))
            return out
        outs = [self._collate_field(samples, p) for p in collate_params]
        if len(outs) == 1:
            return outs[0]
        return tuple(outs) if isinstance(collate_params, tuple) else outs
