"""The port's decoding (avec_tpu_torch/decode/, utils/spm_model.py) against
the JAX package's: the ARPA reader and estimator, the Python prefix beam
search, the native C++ decoder, the device beam search (run here on the
CPU), `CTCBeamSearchDecoder` end to end with test-time augmentation, and
the SentencePiece reader; the three port searches also against the
brute-force oracle of tests/test_beam_oracle.py.

Tolerances: log10 probabilities 1e-6; Python searches 1e-6 on scores with
equal prefixes; native (float32 log-probs) 1e-3 against Python, 1e-9
between its batch and serial calls; device search (fp32) 1e-4 with equal
best prefixes, and equal prefix lists where no two scores tie; oracle
scores as tests/test_beam_oracle.py holds the JAX decoders (1e-9 Python,
1e-3 native, 2e-3 device).

The JAX native decoder is built from its source into the test's tmp_path,
never next to avec_tpu/csrc/.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from avec_tpu.decode import beam as jbeam
from avec_tpu.decode import native as jnative
from avec_tpu.decode.device_beam import (DeviceNgramTables as JaxTables,
                                         device_beam_search as jax_device)
from avec_tpu.decode.ngram import ArpaLM as JaxArpa
from avec_tpu.decode.ngram import estimate_arpa as jax_estimate
from avec_tpu.utils import spm_model as jspm
from avec_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from avec_tpu.utils.tokenizer import train_bpe as jax_train_bpe
from avec_tpu_torch.decode.beam import (CTCBeamSearchDecoder,
                                        ctc_prefix_beam_search)
from avec_tpu_torch.decode.device_beam import (CTCDeviceBeamSearchDecoder,
                                               DeviceNgramTables,
                                               device_beam_search, lm_scores,
                                               pack_key)
from avec_tpu_torch.decode.native import NativeBeamDecoder
from avec_tpu_torch.decode.ngram import ArpaLM, estimate_arpa
from avec_tpu_torch.utils import spm_model as tspm
from avec_tpu_torch.utils.tokenizer import load_tokenizer

from test_beam_oracle import (_full_beam, _rand_logp, _write_random_arpa,
                              brute_force_scores)
from test_decode import ARPA, ARPA3, _peaky_logp

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the native decoder needs g++")


def to_word(offset):
    return lambda i: chr(i + offset)


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    """The fixture ARPA of tests/test_decode.py, its trigram, and an order-6
    model `estimate_arpa` writes over 24 tokens (offset 100)."""
    root = tmp_path_factory.mktemp("arpa")
    paths = {}
    for name, text in (("bigram", ARPA), ("trigram", ARPA3)):
        paths[name] = str(root / f"{name}.arpa")
        with open(paths[name], "w") as f:
            f.write(text)
    rng = np.random.RandomState(0)
    seqs = [[chr(100 + int(t)) for t in rng.randint(1, 24, rng.randint(2, 9))]
            for _ in range(200)]
    paths["6gram"] = estimate_arpa(seqs, str(root / "6gram.arpa"), order=6)
    paths["jax_6gram"] = jax_estimate(seqs, str(root / "j6gram.arpa"), order=6)
    paths["2gram"] = estimate_arpa(seqs, str(root / "2gram.arpa"), order=2)
    paths["jax_2gram"] = jax_estimate(seqs, str(root / "j2gram.arpa"), order=2)
    return paths


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's NativeBeamDecoder, its library built into
    tmp_path."""
    monkeypatch.setattr(jnative, "_LIB", str(tmp_path / "libbeamdecoder.so"))
    monkeypatch.setattr(jnative, "_lib_handle", None)
    return jnative.NativeBeamDecoder


def _lse(x):
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


# ------------------------------------------------------------------ ARPA
def test_arpa_scores_and_written_files_match_jax(arpas):
    """log10_cond and score_sequence on the fixture ARPA and an order-6
    estimate within 1e-6 of the JAX ArpaLM; the estimated files of both
    packages byte-identical."""
    for order in (2, 6):
        with open(arpas[f"{order}gram"], "rb") as f, \
                open(arpas[f"jax_{order}gram"], "rb") as g:
            assert f.read() == g.read()
    rng = np.random.RandomState(1)
    for name, words in (("bigram", "abc"), ("trigram", "abc"),
                        ("6gram", [chr(100 + i) for i in range(26)])):
        got, want = ArpaLM(arpas[name]), JaxArpa(arpas[name])
        assert got.order == want.order
        assert got.probs == want.probs and got.backoffs == want.backoffs
        for _ in range(200):
            hist = [words[i] for i in rng.randint(0, len(words),
                                                   rng.randint(0, 7))]
            w = words[rng.randint(len(words))]
            assert abs(got.log10_cond(w, hist)
                       - want.log10_cond(w, hist)) < 1e-6
            assert abs(got.score_sequence(hist + [w])
                       - want.score_sequence(hist + [w])) < 1e-6
    lm = ArpaLM(arpas["bigram"])
    assert abs(lm.log10_cond("c", ["a"]) - (-1.4)) < 1e-9   # -0.2 + -1.2
    assert lm.log10_cond("z", ["a"]) == -0.2 - 99.0


# --------------------------------------------------------- Python search
@pytest.mark.parametrize("lm_name", [None, "2gram", "6gram"])
def test_python_search_matches_jax(arpas, lm_name):
    """Peaky and random logits (V 24), beams 4 and 8: the same prefixes,
    scores within 1e-6."""
    rng = np.random.RandomState(2)
    kw = {}
    if lm_name:
        kw = dict(alpha=0.7, beta=0.4, token_to_word=to_word(100))
    cases = [_peaky_logp([3, 5, 5, 9, 1], v=24).astype(np.float64)]
    cases += [_rand_logp(rng, int(rng.randint(5, 16)), 24, 2.5)
              for _ in range(3)]
    for logp in cases:
        for beam in (4, 8):
            got = ctc_prefix_beam_search(
                logp, logp.shape[0], beam,
                lm=ArpaLM(arpas[lm_name]) if lm_name else None, **kw)
            want = jbeam.ctc_prefix_beam_search(
                logp, logp.shape[0], beam,
                lm=JaxArpa(arpas[lm_name]) if lm_name else None, **kw)
            assert [p for p, _ in got] == [p for p, _ in want]
            for (_, a), (_, b) in zip(got, want):
                assert abs(a - b) < 1e-6


# ---------------------------------------------------------------- native
def test_native_matches_jax_native_and_python(arpas, jax_native):
    """The port's native build against the JAX native decoder (1e-9) and
    the port's Python search (1e-3) with no LM, the 3-gram (offset 96) and
    the order-6 estimate (offset 100); decode_batch (3 threads) against
    serial decoding; cutoff_top_n 3 against the Python cutoff."""
    rng = np.random.RandomState(3)
    for path, off, v in ((None, 100, 5), (arpas["trigram"], 96, 5),
                         (arpas["6gram"], 100, 24)):
        kw = {} if path is None else dict(alpha=0.6, beta=1.0,
                                          ngram_path=path, ngram_offset=off)
        pkw = {} if path is None else dict(lm=ArpaLM(path), alpha=0.6,
                                           beta=1.0, token_to_word=to_word(off))
        logits = rng.randn(4, 18, v).astype(np.float32) * 2
        lp = (logits - _lse(logits)).astype(np.float32)
        lens = np.array([18, 11, 1, 15], np.int32)
        port = NativeBeamDecoder(blank=0, beam_size=6, num_threads=3, **kw)
        want = jax_native(blank=0, beam_size=6, **kw)
        batch = port.decode_batch(lp, lens)
        for i in range(4):
            serial = port.decode(lp[i], int(lens[i]))
            assert batch[i] == serial
            assert serial == want.decode(lp[i], int(lens[i]))
            py = ctc_prefix_beam_search(lp[i].astype(np.float64),
                                        int(lens[i]), 6, **pkw)
            assert [p for p, _ in py] == [p for p, _ in serial]
            for (_, a), (_, b) in zip(py, serial):
                assert abs(a - b) < 1e-3
    logits = rng.randn(16, 6).astype(np.float32) * 2
    lp = (logits - _lse(logits)).astype(np.float32)
    py = ctc_prefix_beam_search(lp.astype(np.float64), 16, 4, cutoff_top_n=3)
    nat = NativeBeamDecoder(blank=0, beam_size=4, cutoff_top_n=3).decode(lp,
                                                                        16)
    assert [p for p, _ in py] == [p for p, _ in nat]
    peaky = _peaky_logp([1, 2, 1, 3]).astype(np.float32)
    assert NativeBeamDecoder(beam_size=4, cutoff_top_n=2).decode(
        peaky, peaky.shape[0])[0][0] == (1, 2, 1, 3)


# ---------------------------------------------------------------- device
def test_device_lm_scores_walk_the_arpa_backoff(arpas):
    """The packed-key lookups of every (history, token) against
    ArpaLM.log10_cond (the order-6 estimate and the 3-gram), in fp32."""
    rng = np.random.RandomState(4)
    for path, off, v in ((arpas["6gram"], 100, 26), (arpas["trigram"], 96, 5)):
        lm = ArpaLM(path)
        tables = DeviceNgramTables(lm, offset=off, device="cpu")
        hists = [list(rng.randint(0, v, rng.randint(0, 9))) for _ in range(40)]
        packed = torch.tensor([pack_key(h[-6:]) for h in hists])
        got = lm_scores(tables, packed, torch.tensor([len(h) for h in hists]),
                        v).numpy()
        for i, h in enumerate(hists):
            words = [chr(t + off) for t in h]
            want = [lm.log10_cond(chr(w + off), words) for w in range(v)]
            np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-4)


def test_device_search_matches_jax_and_python(arpas):
    """B=3 utterances of ragged lengths, V 24, beam 8: the device search on
    the CPU against the JAX device search and the port's Python search,
    without an LM, with the 2-gram and with the order-6 model (with
    cutoff_top_n 6 too): the same best prefixes, scores within 1e-4, the
    same prefix lists where no two scores tie."""
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 14, 24).astype(np.float32) * 2.5
    lp = (logits - _lse(logits)).astype(np.float32)
    lens = np.array([14, 9, 3], np.int32)
    for name, cutoff in ((None, None), ("2gram", None), ("6gram", None),
                         ("6gram", 6)):
        kw = dict(beam_size=8, alpha=0.7, beta=0.4, cutoff_top_n=cutoff)
        lm = ArpaLM(arpas[name]) if name else None
        got = device_beam_search(
            lp, lens, tables=(DeviceNgramTables(lm, 100, device="cpu")
                              if lm else None), **kw)
        want = jax_device(lp, lens, tables=(JaxTables(JaxArpa(arpas[name]),
                                                      offset=100)
                                            if lm else None), **kw)
        for i in range(3):
            py = ctc_prefix_beam_search(
                lp[i].astype(np.float64), int(lens[i]), 8, lm=lm, alpha=0.7,
                beta=0.4, token_to_word=to_word(100), cutoff_top_n=cutoff)
            for other in (want[i], py):
                assert got[i][0][0] == other[0][0]
                n = min(len(other), len(got[i]))
                scores = [s for _, s in got[i][:n]]
                for (pa, sa), (pb, sb) in zip(got[i][:n], other[:n]):
                    assert abs(sa - sb) < 1e-4 or sa == sb == -np.inf
                    if np.isfinite(sa) and min(
                            abs(sa - s) for s in scores if s is not sa
                    ) > 1e-3:
                        assert pa == pb


# ---------------------------------------------------------------- oracle
@pytest.mark.parametrize("use_lm", [False, True])
def test_three_port_decoders_match_the_oracle(tmp_path, use_lm):
    """tests/test_beam_oracle.py's exhaustive cases: unpruned, the Python,
    native and device searches find the brute-force argmax and every
    labeling's exact score (Python 1e-9, native 1e-3, device 2e-3)."""
    rng = np.random.RandomState(6 + use_lm)
    for trial in range(5):
        t = int(rng.randint(2, 6))
        v = 4 if use_lm else int(rng.randint(2, 5))
        logp = _rand_logp(rng, t, v).astype(np.float32).astype(np.float64)
        pkw, nkw, dkw = {}, {}, {}
        if use_lm:
            arpa = _write_random_arpa(rng, str(tmp_path / f"o{trial}.arpa"),
                                      ["a", "b", "c"])
            a, b = float(rng.uniform(0.2, 1.5)), float(rng.uniform(-0.5, 1.5))
            pkw = dict(lm=ArpaLM(arpa), alpha=a, beta=b,
                       token_to_word=to_word(96))
            nkw = dict(alpha=a, beta=b, ngram_path=arpa, ngram_offset=96)
            dkw = dict(alpha=a, beta=b, tables=DeviceNgramTables(
                ArpaLM(arpa), offset=96, device="cpu"))
        oracle = brute_force_scores(logp, t, **pkw)
        best = max(oracle, key=oracle.get)
        k = _full_beam(v, t)
        searches = {
            "python": (ctc_prefix_beam_search(logp, t, k, **pkw), 1e-9),
            "native": (NativeBeamDecoder(beam_size=k, **nkw).decode(
                logp.astype(np.float32), t), 1e-3),
            "device": (device_beam_search(logp[None].astype(np.float32),
                                          np.array([t]), beam_size=k,
                                          **dkw)[0], 2e-3)}
        for name, (beams, tol) in searches.items():
            assert beams[0][0] == best, (name, trial)
            got = {p: s for p, s in beams if s > -1e29}
            assert set(got) == set(oracle), (name, trial)
            for lab, s in oracle.items():
                assert abs(got[lab] - s) < tol, (name, trial, lab)


# --------------------------------------------------------------- decoders
def test_beam_decoder_with_tta_matches_jax(tmp_path, arpas):
    """(B, naug, T, V) logits with test_time_aug, lengths per augment,
    through the port's decoder (Python and native searches, temperature
    1.3) against the JAX decoder's Python search: the same strings and
    best ids; without an LM too; the targets path; the device decoder's
    strings against the Python search's best beams."""
    pieces = ["<unk>"] + [f"▁w{i}" for i in range(1, 24)]
    tok_path = str(tmp_path / "tok.json")
    JaxTokenizer(pieces).save(tok_path)
    rng = np.random.RandomState(8)
    logits = rng.randn(3, 2, 12, 24).astype(np.float32) * 3
    lens = np.array([[12, 10], [7, 7], [12, 4]], np.int32)
    for ngram in (None, arpas["2gram"]):
        kw = dict(beam_size=6, ngram_path=ngram, ngram_tmp=1.3,
                  ngram_alpha=0.5, ngram_beta=0.7, ngram_offset=100,
                  test_time_aug=True)
        want = jbeam.CTCBeamSearchDecoder(tok_path, use_native=False, **kw)
        for native in (False, True):
            got = CTCBeamSearchDecoder(tok_path, use_native=native, **kw)
            assert got.beam_search(torch.from_numpy(logits), lens) == \
                want.beam_search(logits, lens)
            assert got((torch.from_numpy(logits), torch.from_numpy(lens))) == \
                want((logits, lens))
    labels = np.array([[3, 5, 0], [2, 0, 0]], np.int32)
    assert got((labels, np.array([2, 1], np.int32)), from_logits=False) == \
        want((labels, np.array([2, 1], np.int32)), from_logits=False)

    dev = CTCDeviceBeamSearchDecoder(tok_path, beam_size=6,
                                     ngram_path=arpas["2gram"], ngram_tmp=1.3,
                                     ngram_alpha=0.5, ngram_beta=0.7,
                                     device="cpu")
    flat, flat_lens = logits[:, 0], lens[:, 0]
    texts = dev((torch.from_numpy(flat), torch.from_numpy(flat_lens)))
    lp = dev.log_probs(flat).numpy().astype(np.float64)
    lm = ArpaLM(arpas["2gram"])
    for i in range(3):
        py = ctc_prefix_beam_search(lp[i], int(flat_lens[i]), 6, lm=lm,
                                    alpha=0.5, beta=0.7,
                                    token_to_word=to_word(100))
        assert texts[i] == dev.tokenizer.decode([list(py[0][0])])[0]


def test_native_failure_raises_and_python_is_explicit(tmp_path, monkeypatch):
    """use_native=True raises on a failed build (no silent Python
    fallback); use_native=False searches in Python."""
    from avec_tpu_torch.decode import native

    tok_path = str(tmp_path / "tok.json")
    JaxTokenizer(["<unk>", "▁a", "▁b"]).save(tok_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "missing" / "lib.so")
    monkeypatch.setattr(native, "SRC", tmp_path / "nope.cpp")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        CTCBeamSearchDecoder(tok_path, beam_size=2)
    dec = CTCBeamSearchDecoder(tok_path, beam_size=2, use_native=False)
    assert dec._native is None
    assert dec((_peaky_logp([1, 2], v=3)[None], np.array([6]))) == ["a b"]


# ----------------------------------------------------------- SentencePiece
def _pair(pieces, model_type):
    p, s, t = zip(*pieces)
    return (tspm.SentencePieceModel(p, s, t, model_type),
            jspm.SentencePieceModel(p, s, t, model_type))


def test_sentencepiece_reader_matches_jax(tmp_path):
    """The golden cases of tests/test_spm_model.py through both readers:
    BPE (leftmost tie-break, whitespace collapsing, unk), unigram Viterbi,
    byte fallback, decode's unk surface and controls, proto bytes, and a
    model from trained pieces read back through `load_tokenizer`."""
    from test_spm_model import PIECES

    B = tspm.WORD_BOUNDARY
    cases = [
        (PIECES, tspm.BPE, ["ab", "b ab", "aa", "z", "  ab   ab ", ""]),
        ([("<unk>", 0.0, 2), ("xy", -1.0, 1), ("yz", -1.0, 1),
          ("x", -2.0, 1), ("y", -3.0, 1), ("z", -4.0, 1), (B, -5.0, 1)],
         tspm.BPE, ["xyz", "xyzxyz zy"]),
        ([("<unk>", 0.0, 2), (B + "ab", -1.0, 1), (B + "a", -2.0, 1),
          ("b", -2.5, 1), (B, -5.0, 1), ("a", -3.0, 1)],
         tspm.UNIGRAM, ["ab", "aa", "abq ba"]),
        ([("<unk>", 0.0, 2), (B, -1.0, 1)]
         + [(f"<0x{b:02X}>", -2.0, 6) for b in range(256)],
         tspm.BPE, ["Ω", "a Ω"]),
    ]
    for pieces, mtype, texts in cases:
        got, want = _pair(pieces, mtype)
        assert got.to_bytes() == want.to_bytes()
        for text in texts:
            ids = got.encode(text)
            assert ids == want.encode(text), text
            assert got.decode(ids) == want.decode(ids)
        assert got.encode(texts) == want.encode(texts)
    got, want = _pair(PIECES, tspm.BPE)
    assert got.decode([0, 3, 1, 2]) == want.decode([0, 3, 1, 2]) == "ab"
    assert got.decode([[6, 3], [3]]) == ["b ab", "ab"]

    corpus = ["hello world", "hello there world", "the quick brown fox"]
    pieces = jax_train_bpe(corpus, 48)
    path = str(tmp_path / "trained.model")
    jspm.bpe_model_from_pieces(pieces).save(path)
    assert tspm.bpe_model_from_pieces(pieces).to_bytes() == open(
        path, "rb").read()
    tok = load_tokenizer(path)
    assert isinstance(tok, tspm.SentencePieceModel)
    for text in corpus:
        assert tok.encode(text) == jspm.SentencePieceModel.from_file(
            path).encode(text)
        assert tok.decode(tok.encode(text)) == text


def test_server_beam_decoder_sees_the_real_rows(tmp_path, arpas):
    """`Server(decoder=...)` (tools/serve.py:94-103, :231-248): 3 requests
    in a batch bucket of 4; the beam decoder gets the 3 real rows of the
    forward's logits and the server returns its strings."""
    from avec_tpu_torch.models.zoo import AudioEfficientConformerInterCTC
    from avec_tpu_torch.serve import Server

    tok_path = str(tmp_path / "tok.json")
    JaxTokenizer(["<unk>"] + [f"▁w{i}" for i in range(1, 24)]).save(tok_path)
    beam = CTCBeamSearchDecoder(tok_path, beam_size=4,
                                ngram_path=arpas["2gram"], use_native=False)
    seen = []

    class Recording:
        def device_fn(self, outputs):
            seen.append(tuple(o.shape for o in outputs))
            return beam.device_fn(outputs)

        def __call__(self, outputs):
            return beam(outputs)

    model = AudioEfficientConformerInterCTC(
        vocab_size=24, num_blocks=(1, 1, 1), interctc_blocks=(),
        device="cpu", generator=torch.Generator().manual_seed(0))
    srv = Server(model=model, mode="ao", device="cpu", precision="float32",
                 decoder=Recording())
    rng = np.random.RandomState(3)
    reqs = [{"audio": (rng.randn(n) * 0.1).astype(np.float32)}
            for n in (8000, 12000, 5000)]
    results = srv.transcribe_batch(reqs)
    assert len(seen) == 1 and seen[0][0][0] == 3 and seen[0][1] == (3,)
    inputs = srv._inputs_for_batch(reqs, 16000, 4)
    logits, lengths = srv.forward(inputs)
    want = beam((logits[:3], lengths[:3]))
    assert [r["text"] for r in results] == want
    assert all(r["batch_size"] == 3 and r["latency_s"] >= 0
               for r in results)
