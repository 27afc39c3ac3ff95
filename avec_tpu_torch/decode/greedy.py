"""Greedy CTC decoding to token ids (port of avec_tpu/decode/greedy.py:70-96).

Detokenization needs the tokenizer (avec_tpu/utils/tokenizer.py), which is
not ported yet: the decoder returns token ids.
"""

from typing import List

import torch

from avec_tpu_torch.ops.ctc import ctc_greedy_collapse


class CTCGreedySearchDecoder:
    """argmax -> collapse repeats -> drop blanks, on the device; only the
    packed token ids reach the host."""

    def __init__(self, blank_token: int = 0):
        self.blank_token = blank_token

    def device_fn(self, outputs):
        logits, lengths = outputs
        return ctc_greedy_collapse(torch.argmax(logits, dim=-1), lengths,
                                   blank=self.blank_token)

    def __call__(self, outputs) -> List[List[int]]:
        tokens, tok_lens = (o.cpu() for o in outputs)
        return [tokens[b, :int(tok_lens[b])].tolist()
                for b in range(tokens.shape[0])]
