"""BPE tokenizer in the JSON format (port of avec_tpu/utils/tokenizer.py:35-219).

SentencePiece-style semantics, pure Python:
  * the word-boundary marker "▁" is prepended to each whitespace-separated
    word;
  * id 0 is <unk> and decodes to "" (the CTC blank shares id 0);
  * BPE merges are applied in learned rank order at encode time;
  * decode concatenates pieces and restores the spaces.

A SentencePiece `.model` path is read and written by the port's own proto
reader (`utils/spm_model.py`); the sentencepiece wheel is not used.
"""

import collections
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple, Union

WORD_BOUNDARY = "▁"
UNK_ID = 0
UNK_PIECE = "<unk>"


def _word_to_symbols(word: str) -> Tuple[str, ...]:
    return tuple([WORD_BOUNDARY + word[0]] + list(word[1:]))


def train_bpe(lines: Iterable[str], vocab_size: int) -> List[str]:
    """Learn a BPE vocab: all characters + merged pieces, up to vocab_size.

    Returns the piece list, index = token id (id 0 reserved for <unk>).
    """
    word_freq: Dict[Tuple[str, ...], int] = collections.Counter()
    charset = set()
    for line in lines:
        for word in line.strip().split():
            word_freq[_word_to_symbols(word)] += 1
            charset.add(WORD_BOUNDARY + word[0])
            charset.update(word[1:])

    pieces = [UNK_PIECE] + sorted(charset)
    if len(pieces) >= vocab_size:
        return pieces[:vocab_size]

    words = {w: list(w) for w in word_freq}

    def count_pairs():
        pairs = collections.Counter()
        for w, freq in word_freq.items():
            sym = words[w]
            for a, b in zip(sym, sym[1:]):
                pairs[(a, b)] += freq
        return pairs

    while len(pieces) < vocab_size:
        pairs = count_pairs()
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merged = a + b
        pieces.append(merged)
        for w in words:
            sym = words[w]
            i, out = 0, []
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            words[w] = out
    return pieces


class Tokenizer:
    """BPE encoder/decoder over a learned piece list."""

    def __init__(self, pieces: Sequence[str]):
        self.pieces = list(pieces)
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        # A merge is any piece that splits into two pieces of smaller ids;
        # its rank is its id (a piece learned later merges later).
        self.merge_rank: Dict[Tuple[str, str], int] = {}
        for pid, piece in enumerate(self.pieces):
            if pid == UNK_ID or len(piece) < 2:
                continue
            best = None
            for k in range(1, len(piece)):
                a, b = piece[:k], piece[k:]
                ia, ib = self.piece_to_id.get(a), self.piece_to_id.get(b)
                if ia is not None and ib is not None and ia < pid and ib < pid:
                    cand = max(ia, ib)
                    if best is None or cand < best[0]:
                        best = (cand, (a, b))
            if best is not None:
                self.merge_rank[best[1]] = pid

    def vocab_size(self) -> int:
        return len(self.pieces)

    def _encode_word(self, word: str) -> List[int]:
        sym = list(_word_to_symbols(word))
        while len(sym) > 1:
            best_rank, best_i = None, None
            for i in range(len(sym) - 1):
                r = self.merge_rank.get((sym[i], sym[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            sym[best_i:best_i + 2] = [sym[best_i] + sym[best_i + 1]]
        return [self.piece_to_id.get(s, UNK_ID) for s in sym]

    def encode(self, text: Union[str, List[str]]):
        if isinstance(text, list):
            return [self.encode(t) for t in text]
        ids: List[int] = []
        for word in text.strip().split():
            ids.extend(self._encode_word(word))
        return ids

    def decode(self, ids):
        if ids and isinstance(ids[0], (list, tuple)):
            return [self.decode(x) for x in ids]
        out = []
        for i in ids:
            i = int(i)
            if i == UNK_ID or i < 0 or i >= len(self.pieces):
                continue  # unk_surface="" (the reference's functions.py:194)
            out.append(self.pieces[i])
        return "".join(out).replace(WORD_BOUNDARY, " ").strip()

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"type": "bpe", "pieces": self.pieces}, f)

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path) as f:
            data = json.load(f)
        return cls(data["pieces"])


def train_tokenizer(corpus_path: str, tokenizer_path: str,
                    vocab_size: int = 256, vocab_type: str = "bpe"):
    """Train a BPE tokenizer on the lines of `corpus_path` and save it in the
    JSON format (".json" appended where the path lacks it), or, for a path
    ending in ".model", as a SentencePiece ModelProto."""
    if vocab_type != "bpe":
        raise ValueError(f"vocab_type {vocab_type!r}: only 'bpe'")
    with open(corpus_path) as f:
        pieces = train_bpe(f, vocab_size)
    if tokenizer_path.endswith(".model"):
        from avec_tpu_torch.utils.spm_model import bpe_model_from_pieces

        model = bpe_model_from_pieces(pieces)
        model.save(tokenizer_path)
        return model
    tok = Tokenizer(pieces)
    if not tokenizer_path.endswith(".json"):
        tokenizer_path = tokenizer_path + ".json"
    tok.save(tokenizer_path)
    return tok


def load_tokenizer(path: str):
    """A tokenizer in the JSON format, or a SentencePiece `.model` read by
    `utils/spm_model.py` (tokenizer.py:199-219 without the wheel; where the
    `.model` is missing, the ".json" beside it)."""
    if path.endswith(".model"):
        if os.path.exists(path):
            from avec_tpu_torch.utils.spm_model import SentencePieceModel

            return SentencePieceModel.from_file(path)
        json_path = path[:-len(".model")] + ".json"
        if os.path.exists(json_path):
            return Tokenizer.from_file(json_path)
        raise FileNotFoundError(path)
    return Tokenizer.from_file(path)
