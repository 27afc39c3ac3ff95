"""CTC prefix beam search with ARPA shallow fusion and GPT rescoring (port of
avec_tpu/decode/beam.py:45-341).

Beams accumulate log P_ctc through the (p_blank, p_non_blank) prefix
recursion; extending a prefix by token c adds alpha * ln(10) *
log10 P_lm(c | prefix) + beta, the words being chr(id + offset). Scores
are combined log-likelihoods, best first; the decoder turns them into
negative log-likelihoods whose argmin is the best beam. With a GPT
rescorer each beam's text is re-tokenized with the LM's tokenizer and
total = -beam_score + neural_alpha * NLL - neural_beta * length, where
length is neural_beta * (tokens + 1): neural_beta applies twice, as in the
JAX package.

`CTCBeamSearchDecoder` searches with the native C++ decoder
(`decode/native.py`) when `use_native=True` (a failed build raises) and
with the Python search of this module when `use_native=False`.
"""

import importlib
import importlib.util
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from avec_tpu_torch.decode.ngram import ArpaLM
from avec_tpu_torch.utils.tokenizer import load_tokenizer

LN10 = math.log(10.0)
NEG_INF = -float("inf")

Beams = List[Tuple[Tuple[int, ...], float]]


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def ctc_prefix_beam_search(log_probs: np.ndarray, seq_len: int, beam_size: int,
                           blank: int = 0, lm: Optional[ArpaLM] = None,
                           alpha: float = 0.6, beta: float = 1.0,
                           token_to_word=None,
                           cutoff_top_n: Optional[int] = None) -> Beams:
    """Prefix beam search over the first seq_len frames of (T, V) log-probs.

    Returns up to beam_size (prefix, score) pairs, best first; the score is
    the combined log-likelihood. With `cutoff_top_n` each frame considers
    its top n tokens and the blank."""
    # prefix -> (logp_blank, logp_non_blank, lm_score)
    beams: Dict[Tuple[int, ...], Tuple[float, float, float]] = {
        (): (0.0, NEG_INF, 0.0)}
    v = log_probs.shape[1]
    top_n = min(cutoff_top_n or v, v)

    for t in range(seq_len):
        lp = log_probs[t]
        if top_n < v:
            cand = np.argpartition(-lp, top_n)[:top_n]
            if blank not in cand:
                cand = np.concatenate([cand, [blank]])
        else:
            cand = range(v)
        new_beams: Dict[Tuple[int, ...], Tuple[float, float, float]] = {}

        def acc(prefix, pb, pnb, lmsc):
            opb, opnb, _ = new_beams.get(prefix, (NEG_INF, NEG_INF, lmsc))
            new_beams[prefix] = (_logsumexp2(opb, pb), _logsumexp2(opnb, pnb),
                                 lmsc)

        for prefix, (pb, pnb, lmsc) in beams.items():
            total = _logsumexp2(pb, pnb)
            last = prefix[-1] if prefix else None
            for c in cand:
                p = float(lp[c])
                if c == blank:
                    acc(prefix, total + p, NEG_INF, lmsc)
                elif c == last:
                    # a repeat extends the non-blank path of the prefix ...
                    acc(prefix, NEG_INF, pnb + p, lmsc)
                    # ... or, after a blank, doubles the token
                    if pb != NEG_INF:
                        add = _lm_add(lm, alpha, beta, prefix, c,
                                      token_to_word)
                        acc(prefix + (int(c),), NEG_INF, pb + p, lmsc + add)
                else:
                    add = _lm_add(lm, alpha, beta, prefix, c, token_to_word)
                    acc(prefix + (int(c),), NEG_INF, total + p, lmsc + add)

        scored = sorted(
            new_beams.items(),
            key=lambda kv: -(_logsumexp2(kv[1][0], kv[1][1]) + kv[1][2]))
        beams = dict(scored[:beam_size])

    results = [(prefix, _logsumexp2(pb, pnb) + lmsc)
               for prefix, (pb, pnb, lmsc) in beams.items()]
    results.sort(key=lambda kv: -kv[1])
    return results


def _lm_add(lm, alpha, beta, prefix, c, token_to_word) -> float:
    if lm is None:
        return 0.0
    history = [token_to_word(p) for p in prefix]
    log10p = lm.log10_cond(token_to_word(int(c)), history)
    return alpha * log10p * LN10 + beta


def _logsumexp_np(x, axis=-1):
    m = x.max(axis=axis, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True))


def host_log_probs(logits, tmp: float = 1.0) -> np.ndarray:
    """Logits (numpy or a tensor on any device) -> float32 log-softmax of
    logits / tmp on the host, in the JAX decoder's arithmetic."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    logits = np.asarray(logits, np.float32) / tmp
    return logits - _logsumexp_np(logits)


def import_config(path: str):
    """A config module by file path or dotted module name (beam.py:318-335)."""
    if os.path.isfile(path):
        name = "avec_tpu_torch_neural_config_" + os.path.basename(
            path).replace(".py", "").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        return module
    return importlib.import_module(path.replace(".py", "").replace("/", "."))


class GPTRescorer:
    """Sums of token NLLs of id sequences under a GPT, run in eval mode and
    fp32 on `model`'s device: one forward over the padded batch."""

    def __init__(self, model: torch.nn.Module, pad_token: int = 0):
        self.model = model.eval()
        self.pad_token = pad_token

    @torch.no_grad()
    def __call__(self, seqs: List[List[int]]) -> np.ndarray:
        device = next(self.model.parameters()).device
        lens = torch.tensor([len(s) for s in seqs])
        ids = torch.full((len(seqs), int(lens.max())), self.pad_token,
                         dtype=torch.long)
        for j, s in enumerate(seqs):
            ids[j, :len(s)] = torch.tensor(s, dtype=torch.long)
        ids, lens = ids.to(device), lens.to(device)
        logits = self.model(ids)["output"].float()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        tok = torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
        valid = (torch.arange(ids.shape[1] - 1, device=device)[None, :]
                 < (lens - 1)[:, None])
        return (-(tok * valid).sum(-1)).double().cpu().numpy()


class CTCBeamSearchDecoder:
    """Beam search + n-gram + GPT rescoring decoder (beam.py:117-316).

    `neural_config_path` names a port LM config module (a file or a dotted
    name, e.g. "avec_tpu_torch.configs.lm_tone") that defines
    `build_model(device)` (the GPT), `tokenizer` (a tokenizer or its path),
    `pad_token`, `sos_token`, `eos_token` and `callback_path`; the
    checkpoint `neural_checkpoint` is read from `callback_path` (an absolute
    `neural_checkpoint` is read as it is). The GPT runs on `device`, the
    card unless the caller passes "cpu". `neural_rescorer`, a callable from
    id sequences to their NLL sums, may be given instead. `device_fn`
    passes the logits through, on the device, to `__call__`."""

    def __init__(self, tokenizer_path: str, beam_size: int = 16,
                 ngram_path: Optional[str] = None, ngram_tmp: float = 1.0,
                 ngram_alpha: float = 0.6, ngram_beta: float = 1.0,
                 ngram_offset: int = 100,
                 neural_config_path: Optional[str] = None,
                 neural_checkpoint: Optional[str] = None,
                 neural_rescorer=None,
                 neural_tokenizer_path: Optional[str] = None,
                 neural_alpha: float = 0.6, neural_beta: float = 1.0,
                 neural_pad_token: int = 0,
                 neural_sos_token: Optional[int] = None,
                 neural_eos_token: Optional[int] = None,
                 num_processes: int = 8, test_time_aug: bool = False,
                 use_native: bool = True, device="cuda"):
        self.tokenizer = load_tokenizer(tokenizer_path)
        self.beam_size = beam_size
        self.ngram_tmp = ngram_tmp
        self.ngram_alpha = ngram_alpha
        self.ngram_beta = ngram_beta
        self.ngram_offset = ngram_offset
        self.test_time_aug = test_time_aug
        self.lm = ArpaLM(ngram_path) if ngram_path else None
        self.neural_rescorer = neural_rescorer
        self.neural_tokenizer = (load_tokenizer(neural_tokenizer_path)
                                 if neural_tokenizer_path else None)
        self.neural_alpha = neural_alpha
        self.neural_beta = neural_beta
        self.neural_pad_token = neural_pad_token
        self.neural_sos_token = neural_sos_token
        self.neural_eos_token = neural_eos_token
        if neural_config_path is not None:
            self._build_neural_rescorer(neural_config_path, neural_checkpoint,
                                        device)
        self._native = None
        if use_native:
            from avec_tpu_torch.decode.native import NativeBeamDecoder

            self._native = NativeBeamDecoder(
                blank=0, beam_size=beam_size, alpha=ngram_alpha,
                beta=ngram_beta, ngram_path=ngram_path,
                ngram_offset=ngram_offset, num_threads=num_processes)

    def _build_neural_rescorer(self, config_path: str, checkpoint: str,
                               device) -> None:
        """The GPT of the LM config with `checkpoint`'s weights, its
        tokenizer and special ids (beam.py:175-215)."""
        from avec_tpu_torch.models.zoo import resolve_device
        from avec_tpu_torch.train.checkpoint import load_checkpoint

        config = import_config(config_path)
        model = config.build_model(resolve_device(device))
        payload = load_checkpoint(os.path.join(config.callback_path,
                                               checkpoint))
        model.load_state_dict(payload["model_state_dict"], strict=True)
        self.neural_rescorer = GPTRescorer(model, config.pad_token)
        tok = config.tokenizer
        self.neural_tokenizer = (load_tokenizer(tok) if isinstance(tok, str)
                                 else tok)
        self.neural_pad_token = config.pad_token
        self.neural_sos_token = config.sos_token
        self.neural_eos_token = config.eos_token

    def _token_to_word(self, idx: int) -> str:
        return chr(idx + self.ngram_offset)

    def device_fn(self, outputs):
        """The logits stay as they are (on the device) for `__call__`."""
        return outputs

    def __call__(self, outputs, from_logits: bool = True) -> List[str]:
        """(logits (B, T, V) or, with test_time_aug, (B, naug, T, V),
        lengths) -> the best beams' strings; with from_logits=False,
        (labels, label lengths) -> their strings."""
        if not from_logits:
            labels, lens = (np.asarray(torch.as_tensor(o).cpu())
                            for o in outputs)
            return self.tokenizer.decode(
                [labels[b, :lens[b]].tolist() for b in range(len(labels))])
        lengths = np.asarray(torch.as_tensor(outputs[1]).cpu())
        return self.tokenizer.decode(self.beam_search(outputs[0], lengths))

    def search(self, logp: np.ndarray, lengths: np.ndarray) -> List[Beams]:
        """Per utterance of (N, T, V) float32 log-probs, its beams."""
        if self._native is not None:
            return self._native.decode_batch(logp, lengths.astype(np.int32))
        return [ctc_prefix_beam_search(
            logp[i], int(lengths[i]), self.beam_size, blank=0, lm=self.lm,
            alpha=self.ngram_alpha, beta=self.ngram_beta,
            token_to_word=self._token_to_word) for i in range(logp.shape[0])]

    def beam_search(self, logits, logits_len) -> List[List[int]]:
        """The best beam's token ids per utterance (beam.py:228-286, with
        the test-time-aug flattening)."""
        logits_len = np.asarray(logits_len)
        if self.test_time_aug:
            b, naug = logits.shape[0], logits.shape[1]
            logits = logits.reshape((-1,) + tuple(logits.shape[2:]))
            logits_len = logits_len.reshape(-1)
        else:
            b, naug = logits.shape[0], 1
        all_beams = self.search(host_log_probs(logits, self.ngram_tmp),
                                logits_len)
        for beams in all_beams:
            while len(beams) < self.beam_size:
                beams.append(((), NEG_INF))
        all_beams = [beams[:self.beam_size] for beams in all_beams]
        # negative log-likelihoods: the argmin is the best
        beam_scores = np.array([[-s for _, s in beams] for beams in all_beams])

        if self.neural_rescorer is not None:
            neural_scores, neural_lengths = self.neural_scores(all_beams)
            total = (beam_scores + self.neural_alpha * neural_scores
                     - self.neural_beta * neural_lengths)
            total = total.reshape(b, naug * self.beam_size)
            flat = [beams[k][0] for beams in all_beams
                    for k in range(self.beam_size)]
            per = naug * self.beam_size
            best = total.argmin(axis=-1)
            return [list(flat[i * per:(i + 1) * per][best[i]])
                    for i in range(b)]

        # no rescorer: the best beam of each augment, then the argmin over
        # augments
        top = beam_scores[:, 0].reshape(b, naug)
        best = top.argmin(axis=-1)
        return [list(all_beams[i * naug + best[i]][0][0]) for i in range(b)]

    def neural_scores(self, all_beams) -> Tuple[np.ndarray, np.ndarray]:
        """Per beam, its text's NLL under the GPT ([sos] + ids + [eos]) and
        neural_beta * (len(ids) + 1) (beam.py:289-316)."""
        n = len(all_beams)
        seqs = []
        for beams in all_beams:
            for prefix, _ in beams:
                text = self.tokenizer.decode([list(prefix)])[0]
                ids = self.neural_tokenizer.encode(text)
                seqs.append([self.neural_sos_token] + list(ids)
                            + [self.neural_eos_token])
        scores = np.asarray(self.neural_rescorer(seqs), np.float64)
        lengths = np.array([self.neural_beta * (len(s) - 1) for s in seqs])
        return (scores.reshape(n, self.beam_size),
                lengths.reshape(n, self.beam_size))
