"""Decoders (port of avec_tpu/decode/greedy.py): identity, threshold,
argmax and greedy CTC.

Each decoder splits its work as the training engine runs it: `device_fn`
on the device (an argmax; for CTC the argmax, the collapse of repeats and
the drop of blanks, so only packed token ids reach the host), then the call
on the host. The greedy CTC decoder with a tokenizer (`tokenizer_path`,
JSON format) returns strings, of the predictions or, with
`from_logits=False`, of (labels, label lengths) targets; without one it
returns token ids (the server's use). The others return nested lists.
"""

from typing import List, Optional

import numpy as np
import torch

from avec_tpu_torch.ops.ctc import ctc_greedy_collapse
from avec_tpu_torch.utils.tokenizer import load_tokenizer


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


class IdentityDecoder:
    """The outputs as they are (greedy.py:31-38)."""

    def device_fn(self, outputs):
        return outputs

    def __call__(self, outputs, from_logits: bool = True):
        return _host(outputs).tolist()


class ThresholdDecoder:
    """1 where the output (B, 1) is at least `threshold`, else 0, with the
    last axis dropped (greedy.py:41-55); targets pass as they are."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def device_fn(self, outputs):
        return outputs

    def __call__(self, outputs, from_logits: bool = True):
        arr = _host(outputs)
        if from_logits:
            return np.where(arr >= self.threshold, 1, 0).squeeze(-1).tolist()
        return arr.tolist()


class ArgMaxDecoder:
    """The argmax over `axis` on the device (greedy.py:58-68)."""

    def __init__(self, axis: int = -1):
        self.axis = axis

    def device_fn(self, outputs):
        return torch.argmax(outputs, dim=self.axis)

    def __call__(self, outputs, from_logits: bool = True):
        return _host(outputs).tolist()


class CTCGreedySearchDecoder:
    """argmax -> collapse repeats -> drop blanks -> detokenize."""

    def __init__(self, tokenizer_path: Optional[str] = None,
                 blank_token: int = 0):
        self.tokenizer = (load_tokenizer(tokenizer_path)
                          if tokenizer_path is not None else None)
        self.blank_token = blank_token

    def device_fn(self, outputs):
        logits, lengths = outputs
        return ctc_greedy_collapse(torch.argmax(logits, dim=-1), lengths,
                                   blank=self.blank_token)

    def __call__(self, outputs, from_logits: bool = True):
        """Packed (tokens, lengths) from `device_fn`, or (labels, label
        lengths) targets with from_logits=False: a list of strings with a
        tokenizer, else a list of token-id lists."""
        tokens, lengths = (torch.as_tensor(o).cpu() for o in outputs)
        ids: List[List[int]] = [tokens[b, :int(lengths[b])].tolist()
                                for b in range(tokens.shape[0])]
        if self.tokenizer is None:
            return ids
        return self.tokenizer.decode(ids)
