"""CTC prefix beam search with n-gram shallow fusion on the device (port of
avec_tpu/decode/device_beam.py:65-506).

The whole batch's search is one loop over frames of PyTorch ops batched
over (B, K, V) (K beams, V tokens), so decoding scales with the card, not
with the host's cores. Nothing inside the loop reads back to the host; the
beams are copied to the host once, after the last frame. Frames past an
utterance's length leave its beams as they are.

The algorithm is that of `decode/beam.py:ctc_prefix_beam_search`:

  * beams carry (p_blank, p_non_blank) in log domain and an LM score;
  * per frame the candidates are K "stay" beams (the blank, or a repeat of
    the last token) and K * V "extend" beams (token v appended);
  * an extension prefix_k + v that equals another beam's prefix k' (k' is
    one token longer, ends in v and agrees on the rest: an exact comparison
    of the token rows) is folded into k''s stay candidate and dropped; two
    extensions of distinct beams never collide;
  * the K best candidates by combined score survive (`torch.topk`), their
    token rows gathered and the new token written at their length.

The n-gram lookups evaluate the back-off walk of `ngram.ArpaLM.log10_cond`
for every (beam, token) at once: each order's n-grams are packed into one
int64 key (9 bits per token, the newest in the low bits: order <= 6 and
token ids < 511) and looked up with `torch.searchsorted`. A missing
back-off weight is 0 and a missed unigram -99, as on the host, in fp32.
Extending by v adds alpha * ln(10) * log10 P(v | prefix) + beta; without
an LM neither term is added. NEG = -1e30 stands in for -inf.
"""

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avec_tpu_torch.decode.beam import Beams
from avec_tpu_torch.decode.ngram import ArpaLM
from avec_tpu_torch.utils.tokenizer import load_tokenizer

LN10 = math.log(10.0)
NEG = -1e30
LOG10_NEG_INF = -99.0
BITS = 9                          # bits per token in a packed key
MAX_ORDER = 6                     # 6 x 9 = 54 bits
MAX_VOCAB = (1 << BITS) - 1       # ids 0..510 (id + 1 fits 9 bits)
_KEY_MASK = (1 << (BITS * MAX_ORDER)) - 1


def pack_key(ids) -> int:
    """An n-gram's ids (oldest first) -> its int64 key: id + 1 per 9-bit
    slot, the last id in slot 0."""
    key = 0
    for j, t in enumerate(reversed(ids)):
        key |= (int(t) + 1) << (BITS * j)
    return key


class DeviceNgramTables:
    """An ARPA model's n-grams as per-order sorted int64 keys with their
    log10 probabilities and back-off weights (0 where the file gives none),
    on `device`.

    Only n-grams whose words are all single characters chr(id + offset) with
    0 <= id < 511 are kept: <s>, </s> and other words never occur in a CTC
    prefix's history."""

    def __init__(self, lm: ArpaLM, offset: int = 100, device="cuda"):
        if lm.order > MAX_ORDER:
            raise ValueError(f"ARPA order {lm.order} > {MAX_ORDER}")
        self.order = lm.order

        def tok(word: str) -> Optional[int]:
            i = ord(word) - offset if len(word) == 1 else -1
            return i if 0 <= i < MAX_VOCAB else None

        keys = [[] for _ in range(self.order + 1)]
        for ngram in lm.probs:
            ids = [tok(w) for w in ngram]
            if all(i is not None for i in ids):
                keys[len(ids)].append((pack_key(ids), ngram))
        self.tables = []
        for n in range(1, self.order + 1):
            # an empty order keeps one key that no query equals (queries > 0)
            rows = sorted(keys[n]) or [(-1, None)]
            self.tables.append(dict(
                keys=torch.tensor([k for k, _ in rows], dtype=torch.int64,
                                  device=device),
                prob=torch.tensor([lm.probs.get(g, LOG10_NEG_INF)
                                   for _, g in rows], device=device),
                back=torch.tensor([lm.backoffs.get(g, 0.0) for _, g in rows],
                                  device=device)))


def _lookup(table, q):
    """(index, found) of int64 keys `q` (any shape) in a table's keys."""
    keys = table["keys"]
    idx = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return idx, keys[idx] == q


def lm_scores(tables: DeviceNgramTables, hist: torch.Tensor,
              hist_len: torch.Tensor, vocab: int) -> torch.Tensor:
    """log10 P(v | history) for every v < vocab: (..., V) fp32.

    hist: (...) int64 packed last MAX_ORDER tokens of each history (newest
    in slot 0); hist_len: (...) the history's true length. The walk runs
    from the longest context down: the first order whose (context, v) is
    stored gives its probability plus the back-off weights of the longer
    contexts that missed; no hit gives those weights plus -99."""
    words = torch.arange(1, vocab + 1, dtype=torch.int64, device=hist.device)
    shape = tuple(hist.shape) + (vocab,)
    out = torch.full(shape, LOG10_NEG_INF, device=hist.device)
    found = torch.zeros(shape, dtype=torch.bool, device=hist.device)
    acc = torch.zeros(shape, device=hist.device)
    for n in range(tables.order, 0, -1):
        ctx = hist & ((1 << (BITS * (n - 1))) - 1)
        ok = hist_len >= n - 1
        table = tables.tables[n - 1]
        idx, hit = _lookup(table, (ctx << BITS)[..., None] | words)
        hit &= ok[..., None]
        out = torch.where(hit & ~found, acc + table["prob"][idx], out)
        found |= hit
        if n > 1:
            # the back-off weight of the (n-1)-token context itself
            btable = tables.tables[n - 2]
            bidx, bhit = _lookup(btable, ctx)
            b = torch.where(bhit & ok, btable["back"][bidx], 0.0)
            acc = torch.where(found, acc, acc + b[..., None])
    return torch.where(found, out, acc + LOG10_NEG_INF)


def _logaddexp(a, b):
    mx, mn = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.clamp(mn - mx, -80.0, 0.0)
    return torch.where(mx <= NEG / 2, torch.full_like(mx, NEG),
                       mx + torch.log1p(torch.exp(safe)))


def device_beam_search(logp, lengths, beam_size: int = 16, blank: int = 0,
                       tables: Optional[DeviceNgramTables] = None,
                       alpha: float = 0.6, beta: float = 1.0,
                       cutoff_top_n: Optional[int] = None,
                       device=None) -> List[Beams]:
    """Per utterance of (B, T, V) log-probs and (B,) lengths (numpy or
    tensors), its beams best first as (prefix, combined score) pairs, the
    contract of `ctc_prefix_beam_search`; a beam that never became finite
    is ((), -inf). The search runs in fp32 on `device` (default: logp's);
    its results are copied to the host once, at the end."""
    logp = torch.as_tensor(logp)
    dev = logp.device if device is None else torch.device(device)
    tokens, lens, scores = search_on_device(
        logp.to(dev, torch.float32), torch.as_tensor(lengths).to(dev),
        beam_size, blank, tables, alpha, beta, cutoff_top_n)
    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
    scores = scores.cpu().double().numpy()
    return [[((), -float("inf")) if scores[i, j] <= NEG / 2 else
             (tuple(int(x) for x in tokens[i, j, :lens[i, j]]),
              float(scores[i, j])) for j in range(tokens.shape[1])]
            for i in range(tokens.shape[0])]


def search_on_device(logp: torch.Tensor, lengths: torch.Tensor,
                     beam_size: int, blank: int,
                     tables: Optional[DeviceNgramTables], alpha: float,
                     beta: float, cutoff_top_n: Optional[int]):
    """The frame loop of `device_beam_search` on (B, T, V) fp32 log-probs
    and (B,) lengths on one device: tokens (B, K, T), lengths (B, K) and
    scores (B, K), best first, left on the device. It makes no call that
    waits for the device."""
    dev = logp.device
    b, t_max, v = logp.shape
    if v > MAX_VOCAB:
        raise ValueError(f"vocab {v} > {MAX_VOCAB}")
    k, u = beam_size, max(t_max, 1)
    tokens = torch.zeros((b, k, u), dtype=torch.int64, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int64, device=dev)
    pb = torch.full((b, k), NEG, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((b, k), NEG, device=dev)
    lmsc = torch.zeros((b, k), device=dev)
    hist = torch.zeros((b, k), dtype=torch.int64, device=dev)
    ar_v = torch.arange(v, device=dev)
    ar_u = torch.arange(u, device=dev)
    neg = torch.full((), NEG, device=dev)
    alpha_ln = alpha * LN10

    for t in range(t_max):
        lp = logp[:, t]                                        # (B, V)
        total = _logaddexp(pb, pnb)                            # (B, K)
        last = torch.where(lens > 0, tokens.gather(
            2, (lens - 1).clamp(min=0)[..., None])[..., 0], -1)
        vlast = last.clamp(min=0)
        lp_last = lp.gather(1, vlast)

        # stay candidates: the same prefix
        stay_pb = total + lp[:, blank, None]
        stay_pnb = pnb + torch.where(last >= 0, lp_last, neg)
        # extend candidates: prefix + v
        ext = torch.where(ar_v == last[..., None], pb[..., None],
                          total[..., None]) + lp[:, None, :]
        ext = torch.where((ar_v == blank) | (lens >= u)[..., None], neg, ext)
        if cutoff_top_n is not None and cutoff_top_n < v:
            thresh = torch.topk(lp, cutoff_top_n, dim=-1).values[:, -1:]
            ext = torch.where(lp[:, None, :] >= thresh[..., None], ext, neg)
            # the repeat is a candidate token as well (beam.py)
            stay_pnb = torch.where((last >= 0) & (lp_last >= thresh),
                                   stay_pnb, neg)
        if tables is not None:
            lm_add = alpha_ln * lm_scores(tables, hist, lens, v) + beta
        else:
            lm_add = torch.zeros((b, k, v), device=dev)

        # exact merge: ext(src, last[dst]) equals dst's prefix when dst is
        # one token longer and agrees with src on src's tokens
        agree = ((tokens[:, :, None, :] == tokens[:, None, :, :])
                 | (ar_u >= lens[:, :, None, None]))
        same = (agree.all(-1) & (lens[:, None, :] == lens[:, :, None] + 1)
                & (total[:, :, None] > NEG / 2)
                & (total[:, None, :] > NEG / 2)
                & (last[:, None, :] >= 0))                    # (B, src, dst)
        contrib = torch.where(same, ext.gather(
            2, vlast[:, None, :].expand(b, k, k)), neg)
        top_in = contrib.max(dim=1).values
        merged = torch.where(
            top_in > NEG / 2,
            top_in + torch.log(torch.exp(contrib - top_in[:, None, :]).sum(1)),
            neg)
        stay_pnb = _logaddexp(stay_pnb, merged)
        kill = torch.bmm(same.float(), F.one_hot(vlast, v).float()) > 0
        ext = torch.where(kill, neg, ext)

        # the K best of the K + K * V candidates
        stay_tot = _logaddexp(stay_pb, stay_pnb) + lmsc
        ext_lm = lmsc[..., None] + lm_add
        ext_tot = torch.where(ext > NEG / 2, ext + ext_lm, neg)
        cand = torch.cat([stay_tot, ext_tot.reshape(b, k * v)], dim=1)
        top = torch.topk(cand, k, dim=1).indices
        is_stay = top < k
        parent = torch.where(is_stay, top, (top - k) // v)
        newtok = torch.where(is_stay, 0, (top - k) % v)
        flat = parent * v + newtok

        def g(a):
            return a.gather(1, parent)

        ntokens = tokens.gather(1, parent[..., None].expand(b, k, u))
        nlens = g(lens)
        npb = torch.where(is_stay, g(stay_pb), neg)
        npnb = torch.where(is_stay, g(stay_pnb),
                           ext.reshape(b, k * v).gather(1, flat))
        nlm = torch.where(is_stay, g(lmsc),
                          ext_lm.reshape(b, k * v).gather(1, flat))
        nhist = g(hist)
        nhist = torch.where(is_stay, nhist,
                            ((nhist << BITS) | (newtok + 1)) & _KEY_MASK)
        write = (~is_stay)[..., None] & (ar_u == nlens[..., None])
        ntokens = torch.where(write, newtok[..., None], ntokens)
        nlens = nlens + (~is_stay).long()

        live = (t < lengths)[:, None]                          # (B, 1)
        tokens = torch.where(live[..., None], ntokens, tokens)
        lens, pb, pnb, lmsc, hist = (
            torch.where(live, new, old) for new, old in
            ((nlens, lens), (npb, pb), (npnb, pnb), (nlm, lmsc),
             (nhist, hist)))

    scores = _logaddexp(pb, pnb) + lmsc
    order = torch.argsort(-scores, dim=1)
    return (tokens.gather(1, order[..., None].expand(b, k, u)),
            lens.gather(1, order), scores.gather(1, order))


class CTCDeviceBeamSearchDecoder:
    """The engine's decoder with the whole beam search on the device
    (device_beam.py:451-506): `device_fn` passes the logits through;
    `__call__` takes the log-softmax of logits / ngram_tmp and searches on
    the logits' device, then detokenizes the best beams. The n-gram tables
    live on `device`, the card unless the caller passes "cpu". No GPT
    rescoring (that is `beam.CTCBeamSearchDecoder`'s)."""

    def __init__(self, tokenizer_path: str, beam_size: int = 16,
                 ngram_path: Optional[str] = None, ngram_tmp: float = 1.0,
                 ngram_alpha: float = 0.6, ngram_beta: float = 1.0,
                 ngram_offset: int = 100,
                 cutoff_top_n: Optional[int] = None, blank: int = 0,
                 device="cuda"):
        from avec_tpu_torch.models.zoo import resolve_device

        self.device = resolve_device(device)
        self.tokenizer = load_tokenizer(tokenizer_path)
        self.beam_size = beam_size
        self.ngram_tmp = ngram_tmp
        self.alpha = ngram_alpha
        self.beta = ngram_beta
        self.cutoff_top_n = cutoff_top_n
        self.blank = blank
        self.tables = (DeviceNgramTables(ArpaLM(ngram_path),
                                         offset=ngram_offset,
                                         device=self.device)
                       if ngram_path else None)

    def device_fn(self, outputs):
        return outputs

    def log_probs(self, logits) -> torch.Tensor:
        logits = torch.as_tensor(logits).to(self.device, torch.float32)
        return torch.log_softmax(logits / self.ngram_tmp, dim=-1)

    def search(self, logp, lengths) -> List[Beams]:
        return device_beam_search(
            logp, lengths, beam_size=self.beam_size, blank=self.blank,
            tables=self.tables, alpha=self.alpha, beta=self.beta,
            cutoff_top_n=self.cutoff_top_n, device=self.device)

    def __call__(self, outputs, from_logits: bool = True) -> List[str]:
        if not from_logits:
            labels, lens = (np.asarray(torch.as_tensor(o).cpu())
                            for o in outputs)
            return self.tokenizer.decode(
                [labels[b, :lens[b]].tolist() for b in range(len(labels))])
        beams = self.search(self.log_probs(outputs[0]), outputs[1])
        return self.tokenizer.decode([list(bs[0][0]) for bs in beams])
