"""Word error rate (port of avec_tpu/utils/wer.py:33-73).

Corpus-level WER: total word edit distance over total reference words,
after jiwer-style English standardization (lowercase, common contractions
expanded, punctuation stripped, whitespace collapsed), as the reference's
`jiwer.wer(..., standardize=True)`.
"""

import re
from typing import List, Sequence, Union

_CONTRACTIONS = [
    (r"won't", "will not"), (r"can'?t", "can not"), (r"let's", "let us"),
    (r"ain'?t", "am not"), (r"y'all", "you all"), (r"wanna", "want to"),
    (r"gotta", "got to"), (r"gonna", "going to"), (r"i'm", "i am"),
    (r"(\w+)'ll", r"\1 will"), (r"(\w+)n't", r"\1 not"),
    (r"(\w+)'ve", r"\1 have"), (r"(\w+)'s", r"\1 is"),
    (r"(\w+)'re", r"\1 are"), (r"(\w+)'d", r"\1 would"),
]
_PUNCT = re.compile(r"[^\w\s]")
_WS = re.compile(r"\s+")


def standardize(text: str) -> str:
    """jiwer-style English standardization."""
    text = text.lower()
    for pat, rep in _CONTRACTIONS:
        text = re.sub(pat, rep, text)
    text = _PUNCT.sub("", text)
    return _WS.sub(" ", text).strip()


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Word-level Levenshtein distance (two-row DP)."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (0 if r == h else 1))
        prev = cur
    return prev[-1]


def wer(truths: Union[str, List[str]], preds: Union[str, List[str]],
        do_standardize: bool = True) -> float:
    """Corpus-level WER in [0, inf): sum(edits) / sum(ref words)."""
    if isinstance(truths, str):
        truths = [truths]
    if isinstance(preds, str):
        preds = [preds]
    if len(truths) != len(preds):
        raise ValueError(f"{len(truths)} references, {len(preds)} hypotheses")
    total_edits, total_words = 0, 0
    for t, p in zip(truths, preds):
        if do_standardize:
            t, p = standardize(t), standardize(p)
        tw, pw = t.split(), p.split()
        total_edits += edit_distance(tw, pw)
        total_words += len(tw)
    return total_edits / max(total_words, 1)
