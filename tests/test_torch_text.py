"""The port's text modules vs the JAX package's: WER, the BPE tokenizer, the
tone tokenizer, the greedy decoder's strings and the WordErrorRate metric,
all equal (strings identical, numbers ==) on seeded random inputs."""

import numpy as np
import pytest
import torch

from avec_tpu.data.synthetic import tone_tokenizer as jax_tone_tokenizer
from avec_tpu.decode.greedy import CTCGreedySearchDecoder as JaxGreedy
from avec_tpu.train import metrics as jmetrics
from avec_tpu.utils import tokenizer as jtok
from avec_tpu.utils import wer as jwer
from avec_tpu_torch.data.synthetic import tone_tokenizer
from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
from avec_tpu_torch.train import metrics as tmetrics
from avec_tpu_torch.utils import tokenizer as ttok
from avec_tpu_torch.utils import wer as twer

WORDS = ["the", "cat", "can't", "won't", "I'm", "they're", "it's", "dog",
         "Hello,", "world!", "we'd", "you'll", "gonna", "a", "B", "c.d"]


def _sentences(rng, n, max_words=9):
    return [" ".join(rng.choice(WORDS, size=rng.randint(0, max_words)))
            for _ in range(n)]


def test_wer_standardize_and_edit_distance_are_equal():
    rng = np.random.RandomState(0)
    truths, preds = _sentences(rng, 40), _sentences(rng, 40)
    for t, p in zip(truths, preds):
        assert twer.standardize(t) == jwer.standardize(t)
        tw, pw = t.split(), p.split()
        assert twer.edit_distance(tw, pw) == jwer.edit_distance(tw, pw)
        assert twer.wer(t, p) == jwer.wer(t, p)
        assert twer.wer(t, p, do_standardize=False) == \
            jwer.wer(t, p, do_standardize=False)
    assert twer.wer(truths, preds) == jwer.wer(truths, preds)
    assert 0 < twer.wer(truths, preds)
    with pytest.raises(ValueError):
        twer.wer(["a"], ["a", "b"])


def test_train_bpe_and_tokenizer_round_trips_are_equal(tmp_path):
    rng = np.random.RandomState(1)
    lines = _sentences(rng, 60) + ["lowest newest widest"] * 3
    for vocab in (12, 40, 80):
        pieces = ttok.train_bpe(lines, vocab)
        assert pieces == jtok.train_bpe(lines, vocab)
        got, want = ttok.Tokenizer(pieces), jtok.Tokenizer(pieces)
        assert got.merge_rank == want.merge_rank
        assert got.vocab_size() == want.vocab_size()
        for line in lines[:20]:
            ids = got.encode(line)
            assert ids == want.encode(line)
            assert got.decode(ids) == want.decode(ids)
        assert got.encode(lines[:5]) == want.encode(lines[:5])
        batch = [got.encode(x) for x in lines[:5]]
        assert got.decode(batch) == want.decode(batch)
        assert got.decode([0, -1, 10 ** 6]) == want.decode([0, -1, 10 ** 6])
        path = str(tmp_path / f"tok{vocab}.json")
        got.save(path)
        assert jtok.Tokenizer.from_file(path).pieces == pieces
        assert ttok.load_tokenizer(path).pieces == pieces
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(lines))
    tok = ttok.train_tokenizer(str(corpus), str(tmp_path / "trained"), 30)
    want = jtok.train_tokenizer(str(corpus), str(tmp_path / "want.json"), 30)
    assert tok.pieces == want.pieces
    assert (tmp_path / "trained.json").exists()


def test_sentencepiece_model_paths_are_not_ported(tmp_path):
    """A `.model` path: missing, it raises FileNotFoundError as the JAX
    loader does without the wheel; trained, it writes the same ModelProto
    bytes as the JAX package's `train_tokenizer`, and the port reads it back
    with the same pieces and segmentation (the name predates the port's
    SentencePiece reader)."""
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(str(tmp_path / "tokenizerbpe256.model"))
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b\nab ba b\n")
    got = ttok.train_tokenizer(str(corpus), str(tmp_path / "t.model"), 8)
    jtok.train_tokenizer(str(corpus), str(tmp_path / "j.model"), 8)
    assert ((tmp_path / "t.model").read_bytes()
            == (tmp_path / "j.model").read_bytes())
    back = ttok.load_tokenizer(str(tmp_path / "t.model"))
    assert back.pieces == got.pieces
    assert back.encode("ab ba b") == got.encode("ab ba b")


def test_tone_tokenizer_pieces_are_equal():
    got, want = tone_tokenizer(32), jax_tone_tokenizer(32)
    assert got.pieces == want.pieces and len(got.pieces) == 32
    ids = [[3, 17, 31], [1], []]
    assert got.decode(ids) == want.decode(ids) == ["w3 w17 w31", "w1", ""]


def test_greedy_decoder_strings_are_equal(tmp_path):
    """The same logits and lengths through both decoders: the device part
    (argmax, collapse) and the host part (detokenization) of each, on
    random logits with runs of repeats and blanks, lengths down to 0; and
    the targets (from_logits=False)."""
    path = str(tmp_path / "tokenizer.json")
    tone_tokenizer(32).save(path)
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 40, 32).astype(np.float32)
    logits[:, ::3, 0] += 3.0                   # blanks
    logits[:, 1::7] = logits[:, 0::7][:, :logits[:, 1::7].shape[1]]  # repeats
    lengths = np.array([40, 33, 17, 5, 1, 0], np.int32)
    got_dec = CTCGreedySearchDecoder(tokenizer_path=path)
    want_dec = JaxGreedy(tokenizer_path=path)
    pre = got_dec.device_fn((torch.from_numpy(logits),
                             torch.from_numpy(lengths)))
    want_pre = want_dec.device_fn((logits, lengths))
    got = got_dec(pre)
    want = want_dec(tuple(np.asarray(a) for a in want_pre))
    assert got == want and len(got) == 6 and got[-1] == ""
    assert sum(len(s.split()) for s in got) > 20
    labels = rng.randint(1, 32, size=(6, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 3, 1, 0, 2], np.int32)
    assert got_dec((labels, label_lens), from_logits=False) == \
        want_dec((labels, label_lens), from_logits=False)
    ids = CTCGreedySearchDecoder()(pre)          # without a tokenizer: ids
    assert [len(x) for x in ids] == [len(s.split()) for s in got]


def test_metrics_are_equal():
    rng = np.random.RandomState(3)
    truths, preds = _sentences(rng, 30), _sentences(rng, 30)
    assert tmetrics.WordErrorRate()(truths, preds) == \
        jmetrics.WordErrorRate()(truths, preds)
    assert tmetrics.WordErrorRate.on_host and \
        tmetrics.WordErrorRate().name == "wer"
    y = rng.randint(-1, 5, size=(4, 7))
    logits = rng.randn(4, 7, 5).astype(np.float32)
    for tm, jm in ((tmetrics.CategoricalAccuracy(),
                    jmetrics.CategoricalAccuracy()),
                   (tmetrics.CategoricalAccuracyTopK(topk=2),
                    jmetrics.CategoricalAccuracyTopK(topk=2))):
        got = float(tm(torch.from_numpy(y), torch.from_numpy(logits)))
        want = float(jm(y, logits))
        assert got == pytest.approx(want, rel=1e-6) and 0 < got < 100
        assert tm.name == jm.name and not tm.on_host
    assert float(tmetrics.Mean()(None, torch.from_numpy(logits))) == \
        pytest.approx(float(jmetrics.Mean()(None, logits)), rel=1e-6)
