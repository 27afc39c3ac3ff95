"""SentencePiece `.model` files without the sentencepiece wheel (port of
avec_tpu/utils/spm_model.py:94-297).

The released tokenizers (tokenizerbpe256.model, tokenizerbpe1024.model) are
SentencePiece ModelProto files trained with model_type="bpe", bos/eos
disabled and unk_surface="". This module reads and writes the proto wire
format itself and segments as sentencepiece does:

  * BPE: merge the adjacent symbol pair whose concatenation is the piece of
    the highest score, the leftmost pair on ties; a symbol that is no piece
    falls back to byte pieces (<0xNN>) where the model has them, else unk.
  * Unigram: the Viterbi path over piece scores; an unknown character is
    unk at the lowest score less 10.

Normalization: remove_extra_whitespaces, add_dummy_prefix and
escape_whitespaces (" " -> U+2581). Decoding drops unknown, control and
unused pieces (unk_surface="") and joins byte pieces as UTF-8.

ModelProto schema (sentencepiece_model.proto):
  ModelProto:    1 repeated SentencePiece pieces; 2 TrainerSpec; 3 NormalizerSpec
  SentencePiece: 1 string piece; 2 float score; 3 enum type
                 (NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4 UNUSED=5 BYTE=6)
  TrainerSpec:   3 enum model_type (UNIGRAM=1 BPE=2 WORD=3 CHAR=4)
"""

import math
import struct
from typing import List, Optional, Sequence, Tuple, Union

WORD_BOUNDARY = "▁"

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2


# ------------------------------------------------------------ wire format

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                    # fixed64
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:                    # length-delimited
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:                    # fixed32
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _field(tag_field: int, wire: int) -> bytes:
    return _write_varint((tag_field << 3) | wire)


# -------------------------------------------------------------- the model

class SentencePieceModel:
    """Parsed ModelProto with encode/decode (drop-in Tokenizer interface)."""

    def __init__(self, pieces: Sequence[str], scores: Sequence[float],
                 types: Sequence[int], model_type: int = BPE):
        self.pieces = list(pieces)
        self.scores = list(scores)
        self.types = list(types)
        self.model_type = model_type
        self.piece_to_id = {}
        for i, p in enumerate(self.pieces):
            self.piece_to_id.setdefault(p, i)
        self.unk_id = next((i for i, t in enumerate(self.types)
                            if t == UNKNOWN), 0)
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)

    # -- io ---------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces, scores, types = [], [], []
        model_type = BPE
        for field, wire, val in _iter_fields(data):
            if field == 1 and wire == 2:       # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                pieces.append(piece)
                scores.append(score)
                types.append(ptype)
            elif field == 2 and wire == 2:     # TrainerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 3 and w2 == 0:
                        model_type = v2
        return cls(pieces, scores, types, model_type)

    def to_bytes(self) -> bytes:
        out = bytearray()
        for piece, score, ptype in zip(self.pieces, self.scores, self.types):
            sp = bytearray()
            pb = piece.encode("utf-8")
            sp += _field(1, 2) + _write_varint(len(pb)) + pb
            sp += _field(2, 5) + struct.pack("<f", score)
            sp += _field(3, 0) + _write_varint(ptype)
            out += _field(1, 2) + _write_varint(len(sp)) + bytes(sp)
        trainer = _field(3, 0) + _write_varint(self.model_type)
        out += _field(2, 2) + _write_varint(len(trainer)) + trainer
        return bytes(out)

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    # -- normalization ------------------------------------------------------
    @staticmethod
    def _normalize(text: str) -> str:
        words = text.split()
        if not words:
            return ""
        return WORD_BOUNDARY + (WORD_BOUNDARY.join(words))

    # -- encode -------------------------------------------------------------
    def vocab_size(self) -> int:
        return len(self.pieces)

    def encode(self, text: Union[str, List[str]]):
        if isinstance(text, list):
            return [self.encode(t) for t in text]
        norm = self._normalize(text)
        if not norm:
            return []
        if self.model_type == UNIGRAM:
            return self._encode_unigram(norm)
        return self._encode_bpe(norm)

    def _encode_bpe(self, norm: str) -> List[int]:
        # sentencepiece BPE merges across the whole normalized sentence (the
        # boundary marker prevents cross-word merges unless a piece spans it).
        sym: List[str] = list(norm)
        while len(sym) > 1:
            best_score, best_i = None, None
            for i in range(len(sym) - 1):
                pid = self.piece_to_id.get(sym[i] + sym[i + 1])
                if pid is None or self.types[pid] != NORMAL:
                    continue
                s = self.scores[pid]
                if best_score is None or s > best_score:
                    best_score, best_i = s, i
            if best_i is None:
                break
            sym[best_i:best_i + 2] = [sym[best_i] + sym[best_i + 1]]
        out = []
        for s in sym:
            pid = self.piece_to_id.get(s)
            if pid is None:
                out.extend(self._unk_or_bytes(s))
            else:
                out.append(pid)
        return out

    def _encode_unigram(self, norm: str) -> List[int]:
        n = len(norm)
        best = [(-math.inf, -1, -1)] * (n + 1)  # (logp, prev, piece_id)
        best[0] = (0.0, -1, -1)
        unk_penalty = min(self.scores) - 10.0 if self.scores else -20.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_piece_len), end):
                if best[start][0] == -math.inf:
                    continue
                sub = norm[start:end]
                pid = self.piece_to_id.get(sub)
                if pid is not None and self.types[pid] == NORMAL:
                    cand = best[start][0] + self.scores[pid]
                    if cand > best[end][0]:
                        best[end] = (cand, start, pid)
                elif end - start == 1:    # unk char
                    cand = best[start][0] + unk_penalty
                    if cand > best[end][0]:
                        best[end] = (cand, start, self.unk_id)
        ids = []
        pos = n
        while pos > 0:
            _, prev, pid = best[pos]
            ids.append(pid)
            pos = prev
        return ids[::-1]

    def _unk_or_bytes(self, s: str) -> List[int]:
        out = []
        for ch in s:
            # byte fallback when BYTE pieces exist, else unk
            ids = [self.piece_to_id.get(f"<0x{b:02X}>")
                   for b in ch.encode("utf-8")]
            if all(i is not None for i in ids):
                out.extend(ids)
            else:
                out.append(self.unk_id)
        return out

    # -- decode -------------------------------------------------------------
    def decode(self, ids):
        if ids and isinstance(ids[0], (list, tuple)):
            return [self.decode(x) for x in ids]
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="ignore"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.pieces):
                continue
            t = self.types[i]
            if t in (UNKNOWN, CONTROL, UNUSED):
                continue  # unk_surface=""
            if t == BYTE:
                byte_buf.append(int(self.pieces[i][3:5], 16))
                continue
            flush()
            parts.append(self.pieces[i])
        flush()
        return "".join(parts).replace(WORD_BOUNDARY, " ").strip()


def bpe_model_from_pieces(pieces: Sequence[str],
                          merges: Optional[Sequence[str]] = None
                          ) -> SentencePieceModel:
    """Build a BPE SentencePieceModel from an ordered piece list (the
    output of `utils.tokenizer.train_bpe`): merged pieces get score -rank in merge order,
    single-symbol pieces trail with lower scores (sentencepiece layout)."""
    def is_merge(p):
        # a piece of >1 symbols (the boundary marker counts as one symbol)
        return len(p) - (1 if p.startswith(WORD_BOUNDARY) else 0) > 1 or (
            not p.startswith(WORD_BOUNDARY) and len(p) > 1)

    scores, types = [], []
    merge_rank = 0
    char_rank = 0
    n_merges = sum(1 for p in pieces if p != "<unk>" and is_merge(p))
    for p in pieces:
        if p == "<unk>":
            scores.append(0.0)
            types.append(UNKNOWN)
        elif is_merge(p):
            scores.append(-float(merge_rank))
            types.append(NORMAL)
            merge_rank += 1
        else:
            scores.append(-float(n_merges + char_rank))
            types.append(NORMAL)
            char_rank += 1
    return SentencePieceModel(pieces, scores, types, BPE)
