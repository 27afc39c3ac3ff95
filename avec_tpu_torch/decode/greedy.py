"""Greedy CTC decoding (port of avec_tpu/decode/greedy.py:70-96).

`device_fn` runs on the device: argmax, collapse repeats, drop blanks; only
the packed token ids reach the host. The call finishes on the host: with a
tokenizer (`tokenizer_path`, JSON format) it returns strings, of the
predictions or, with `from_logits=False`, of (labels, label lengths)
targets; without one it returns token ids (the server's use).
"""

from typing import List, Optional

import torch

from avec_tpu_torch.ops.ctc import ctc_greedy_collapse
from avec_tpu_torch.utils.tokenizer import load_tokenizer


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
