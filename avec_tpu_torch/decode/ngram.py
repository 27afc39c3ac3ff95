"""ARPA n-gram language model: reader, Katz back-off scorer and a small
estimator (port of avec_tpu/decode/ngram.py:29-161).

Scoring is the standard back-off walk in log10:

  P(w | h) = p(h, w)                       if (h, w) is in the table
           = backoff(h) + P(w | h[1:])     otherwise

A missing back-off weight is 0 and an unseen unigram is -99. The words are
the decoder's remapped tokens, chr(id + offset), so one ARPA file scores
alike in the Python, native and device decoders.
"""

import gzip
import math
from typing import Dict, List, Sequence, Tuple

LOG10_NEG_INF = -99.0


class ArpaLM:
    """In-memory backoff n-gram LM from an ARPA file (log10 probs)."""

    def __init__(self, path: str):
        self.probs: Dict[Tuple[str, ...], float] = {}
        self.backoffs: Dict[Tuple[str, ...], float] = {}
        self.order = 0
        self._parse(path)

    # ASCII whitespace only: the remapped words chr(id + offset) include
    # Unicode whitespace (U+00A0 is id 60 at offset 100, U+0085 id 33),
    # which str.strip() / str.split() would take as separators; the native
    # decoder parses the file byte-wise.
    _WS = " \t\r\n"

    def _parse(self, path: str):
        import re

        opener = gzip.open if path.endswith(".gz") else open
        ws_split = re.compile(r"[ \t]+").split
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            section = 0
            for line in f:
                line = line.strip(self._WS)
                if not line:
                    continue
                if line.startswith("\\") and "grams:" in line:
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\"):
                    section = 0
                    continue
                if section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = [p for p in ws_split(line) if p]
                    if len(parts) < section + 1:
                        continue
                    logp = float(parts[0])
                    ngram = tuple(parts[1:1 + section])
                    backoff = (float(parts[1 + section])
                               if len(parts) > 1 + section else None)
                else:
                    logp = float(parts[0])
                    ngram = tuple(p for p in parts[1].split(" ") if p)
                    backoff = float(parts[2]) if len(parts) > 2 else None
                self.probs[ngram] = logp
                if backoff is not None:
                    self.backoffs[ngram] = backoff

    def log10_cond(self, word: str, history: Sequence[str]) -> float:
        """log10 P(word | history) with backoff."""
        history = tuple(history[-(self.order - 1):]) if self.order > 1 else ()
        while True:
            ngram = history + (word,)
            if ngram in self.probs:
                return self.probs[ngram]
            if not history:
                return self.probs.get((word,), LOG10_NEG_INF)
            bo = self.backoffs.get(history, 0.0)
            history = history[1:]
            if bo != 0.0:
                return bo + self.log10_cond(word, history)

    def score_sequence(self, words: Sequence[str], bos: bool = True) -> float:
        """Total log10 prob of a word sequence."""
        history: List[str] = ["<s>"] if bos else []
        total = 0.0
        for w in words:
            total += self.log10_cond(w, history)
            history.append(w)
        return total


def estimate_arpa(sequences: Sequence[Sequence[str]], path: str,
                  order: int = 2, add_k: float = 0.1) -> str:
    """Estimate a back-off n-gram LM from word sequences and write it as
    ARPA: add-k smoothed counts, every back-off weight -0.3. Every observed
    n-gram's suffix is an observed (n-1)-gram, as in a real ARPA file. The
    synthetic configs decode with it in place of a KenLM model."""
    counts = [ {} for _ in range(order + 1) ]  # n -> tuple -> count
    vocab = set()
    for seq in sequences:
        words = list(seq)
        vocab.update(words)
        toks = ["<s>"] + words + ["</s>"]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                g = tuple(toks[i: i + n])
                if n == 1 and g == ("<s>",):
                    pass  # unigram <s> carries prob 0 conventionally
                counts[n][g] = counts[n].get(g, 0) + 1
    vocab = sorted(vocab) + ["<s>", "</s>"]
    v = len(vocab)

    def cond_log10(g):
        n = len(g)
        c = counts[n].get(g, 0)
        denom = (counts[n - 1].get(g[:-1], 0) if n > 1
                 else sum(counts[1].values()))
        return math.log10((c + add_k) / (denom + add_k * v))

    lines = ["\\data\\"]
    grams = []
    for n in range(1, order + 1):
        if n == 1:
            g_n = [(w,) for w in vocab]
        else:
            g_n = sorted(counts[n])
        grams.append(g_n)
        lines.append(f"ngram {n}={len(g_n)}")
    lines.append("")
    for n in range(1, order + 1):
        lines.append(f"\\{n}-grams:")
        for g in grams[n - 1]:
            p = LOG10_NEG_INF if g == ("<s>",) else cond_log10(g)
            bo = "\t-0.3" if n < order else ""
            lines.append(f"{p:.6f}\t{' '.join(g)}{bo}")
        lines.append("")
    lines.append("\\end\\")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
