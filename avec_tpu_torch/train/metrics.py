"""Metrics (port of avec_tpu/train/metrics.py:22-90).

The accuracy family works on tensors on the device; WordErrorRate runs on
the host (`on_host = True`) over the strings a decoder returns, as the
engine's evaluation feeds it.
"""

import torch

from avec_tpu_torch.utils.wer import wer


class Mean:
    name = "mean"
    on_host = False

    def __call__(self, y_true, y_pred):
        return y_pred.mean()


class CategoricalAccuracy:
    """Accuracy x 100 over the entries whose target is not ignore_index."""

    on_host = False

    def __init__(self, ignore_index=-1, dim_argmax=-1, name="acc"):
        self.ignore_index = ignore_index
        self.dim_argmax = dim_argmax
        self.name = name

    def __call__(self, y_true, y_pred):
        if self.dim_argmax is not None:
            y_pred = y_pred.argmax(dim=self.dim_argmax)
        mask = (y_true != self.ignore_index).float()
        n = torch.count_nonzero(mask)
        acc = (y_true == y_pred).float() * mask
        return 100.0 * acc.sum() / torch.clamp(n, min=1)


class CategoricalAccuracyTopK:
    """Top-k accuracy x 100 over the entries whose target is not
    ignore_index."""

    on_host = False

    def __init__(self, ignore_index=-1, topk=5, name=None):
        self.ignore_index = ignore_index
        self.topk = topk
        self.name = name if name is not None else f"topk{topk}"

    def __call__(self, y_true, y_pred):
        mask = (y_true != self.ignore_index).float()
        n = torch.count_nonzero(mask)
        indices = torch.topk(y_pred, self.topk, dim=-1).indices
        hit = (indices == y_true[..., None]).any(dim=-1).float() * mask
        return 100.0 * hit.sum() / torch.clamp(n, min=1)


class WordErrorRate:
    """Corpus WER x 100 over decoded strings."""

    on_host = True

    def __init__(self, name="wer"):
        self.name = name

    def __call__(self, targets, outputs):
        return 100.0 * wer(targets, outputs, do_standardize=True)


metric_dict = {
    "CategoricalAccuracy": CategoricalAccuracy,
    "WordErrorRate": WordErrorRate,
}
