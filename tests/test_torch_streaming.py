"""The port's streaming against the JAX package: the Transformer-XL
attention's key/value cache, the carried state of the causal encoder
(`stream_step`), `CausalStreamingTranscriber` and `StreamingTranscriber`.

Sizes are small: the AO model at blocks (2, 2, 1), vocab 32, left context 32
stage-1 frames, chunks of 16 fbank frames, audio of 1.3-3 s (8-12 s for
the windowed transcriber), fp32 on the CPU, weights drawn with numpy for
the JAX variables' shapes (`tests/test_torch_support.py`). Tolerances: the
attention 1e-4; the causal transcriber's logits 2e-3 of the JAX
transcriber's with identical tokens, 2e-4 of the port's own offline causal
forward; the bidirectional transcriber's final text equal to the offline
greedy decode of the same bucket, and in windowed mode every partial, the
commits and the forwards per bucket identical to the JAX transcriber's.
"""

import jax
import jax.numpy as jnp
from avec_tpu.train.losses import CTCLoss as JCTCLoss
import numpy as np
import pytest
import torch

from avec_tpu.decode import causal_streaming as jcs
from avec_tpu.decode import streaming as jst
from avec_tpu.models import zoo as jzoo
from avec_tpu.ops import attention as jatt
from avec_tpu.ops import masks as jmasks
from avec_tpu_torch.convert import params_from_jax
from avec_tpu_torch.decode.causal_streaming import (CausalStreamingTranscriber,
                                                    _od)
from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
from avec_tpu_torch.decode import streaming as pst
from avec_tpu_torch.decode.streaming import (StreamingTranscriber,
                                             _collapse_host, _find_blank_cut)
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       randomize_batch_stats)
from avec_tpu_torch.ops import masks
from avec_tpu_torch.ops.attention import RelPosMultiHeadSelfAttention
from avec_tpu_torch.utils.tokenizer import Tokenizer, train_bpe

from test_torch_support import init_variables, random_variables, t

torch.set_num_threads(1)

SMALL = dict(vocab_size=32, num_blocks=(2, 2, 1), interctc_blocks=())
LEFT = 32


class _IdTok:
    def decode(self, ids_list):
        return [" ".join(map(str, ids)) for ids in ids_list]


class _IdDec:
    """A greedy decoder stand-in: blank 0, ids joined as text."""
    blank_token = 0
    tokenizer = _IdTok()


class _TokDec:
    """A greedy decoder stand-in with a tokenizer, for both packages."""
    blank_token = 0

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer


# ----------------------------------------------------- the attention cache
@pytest.mark.parametrize("causal,th,tq", [(True, 4, 3), (True, 8, 8),
                                          (False, 5, 4)])
def test_xl_attention_cache_matches_jax(causal, th, tq):
    """RelPosMultiHeadSelfAttention with `hidden` (B = 2, D = 24, 4 heads)
    against the JAX layer with the same weights: the output and the
    returned cache (the history's keys / values before the chunk's) within
    1e-4, under a causal band over [history | chunk] with padding."""
    d, heads = 24, 4
    rng = np.random.RandomState(th + tq)
    x = rng.randn(2, tq, d).astype(np.float32)
    hk, hv = (rng.randn(2, th, d).astype(np.float32) for _ in range(2))
    jmod = jatt.RelPosMultiHeadSelfAttention(dim_model=d, num_heads=heads,
                                             causal=causal)
    params, _ = init_variables(jmod, jnp.asarray(x), seed=5)
    port = RelPosMultiHeadSelfAttention(d, heads, causal=causal)
    port.load_state_dict(params_from_jax(params), strict=True)
    rows = np.arange(tq)[:, None]
    cols = np.arange(th + tq)[None, :]
    band = (cols <= rows + th) if causal else np.ones((tq, th + tq), bool)
    mask = band[None, None] & (cols < th + tq - np.array([0, 1])[:, None,
                                                                None, None])
    want, want_h = jmod.apply(
        {"params": params}, jnp.asarray(x), mask=jnp.asarray(mask),
        hidden={"K": jnp.asarray(hk), "V": jnp.asarray(hv)},
        return_hidden=True)
    with torch.no_grad():
        got, got_h = port(t(x), mask=t(mask),
                          hidden={"K": t(hk), "V": t(hv)},
                          return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    for k in ("K", "V"):
        assert got_h[k].shape == (2, th + tq, d)
        assert not got_h[k].requires_grad
        np.testing.assert_allclose(got_h[k].numpy(), np.asarray(want_h[k]),
                                   rtol=0, atol=1e-4)


def test_xl_incremental_matches_full():
    """tests/test_streaming.py::test_xl_incremental_matches_full on the
    port: the chunks 0-3, 3-5, 5-8 with a growing cache give the full causal
    pass (1e-4); the JAX layer on the same weights gives the same."""
    d, h, tl = 16, 2, 8
    x = np.random.RandomState(0).randn(1, tl, d).astype(np.float32)
    jmod = jatt.RelPosMultiHeadSelfAttention(dim_model=d, num_heads=h,
                                             causal=True)
    params, _ = init_variables(jmod, jnp.asarray(x), seed=1)
    port = RelPosMultiHeadSelfAttention(d, h, causal=True)
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        full = port(t(x), mask=masks.make_mask(tl, right_context=0))
        hidden, outs = None, []
        for start, end in ((0, 3), (3, 5), (5, 8)):
            th = 0 if hidden is None else hidden["K"].shape[1]
            tq = end - start
            rows = torch.arange(tq)[:, None]
            cols = torch.arange(th + tq)[None, :]
            out, hidden = port(t(x[:, start:end]),
                               mask=(cols <= rows + th)[None, None],
                               hidden=hidden, return_hidden=True)
            outs.append(out)
    inc = torch.cat(outs, dim=1)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      mask=jmasks.make_mask(tl, right_context=0))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_offline_xl_attention_unchanged_without_cache():
    """No `hidden`: the output is bit-identical to the call that passes
    none of the new arguments, and `return_hidden` alone returns the
    layer's own keys / values."""
    d, heads, tl = 24, 4, 9
    port = RelPosMultiHeadSelfAttention(d, heads, causal=True)
    gen = torch.Generator().manual_seed(0)
    for p in port.parameters():
        with torch.no_grad():
            p.uniform_(-0.2, 0.2, generator=gen)
    x = torch.randn(2, tl, d, generator=gen)
    mask = masks.make_mask(tl, torch.tensor([9, 6]), left_context=3,
                           right_context=0)
    with torch.no_grad():
        a = port(x, mask=mask)
        b, cache = port(x, mask=mask, return_hidden=True)
        k = port.key_layer(x)
    assert torch.equal(a, b)
    assert torch.equal(cache["K"], k)


# ------------------------------------------------------ host collapse / cut
def test_collapse_host_matches_jax():
    rng = np.random.RandomState(0)
    for trial in range(20):
        preds = rng.randint(0, 5, size=rng.randint(0, 40))
        prev = [None, 0, 3][trial % 3]
        assert (_collapse_host(preds, 0, prev)
                == jst._collapse_host(preds, 0, prev))


@pytest.mark.parametrize("seed", range(4))
def test_find_blank_cut_matches_jax(seed):
    """The cases of tests/test_streaming_transcriber.py::test_find_blank_cut
    and random frame sequences at every horizon and run length."""
    fixed = [(np.array([1, 1, 2, 0, 0, 3, 0, 0, 4]), 6),
             (np.array([1, 1, 2, 0, 0, 3, 0, 0, 4]), 9),
             (np.array([1, 1, 2, 0, 0, 3, 0, 0, 4]), 3),
             (np.array([1, 2, 3, 4]), 4), (np.array([1, 0, 2, 0, 0]), 5),
             (np.array([1, 0, 2, 0, 3]), 5)]
    assert [_find_blank_cut(p, h) for p, h in fixed] == [5, 8, -1, -1, 5, -1]
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, 3, size=30)
    for horizon in range(0, 33):
        for run in (1, 2, 3):
            assert (_find_blank_cut(preds, horizon, 0, run)
                    == jst._find_blank_cut(preds, horizon, 0, run))


# ------------------------------------------------ the causal transcriber
@pytest.fixture(scope="module")
def causal():
    """The JAX causal AO model at blocks (2, 2, 1) with seeded variables
    (set, not built), and the port model carrying them."""
    jmodel = jzoo.AudioEfficientConformerInterCTC(causal=True,
                                                  left_context=LEFT, **SMALL)
    jmodel.compile(losses=JCTCLoss(zero_infinity=True, assert_shorter=False))
    args = (np.zeros((1, 16000), np.float32), np.array([16000], np.int32))
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    params, stats = random_variables(shapes, seed=2)
    jmodel.params, jmodel.batch_stats, jmodel.built = params, stats, True
    port = AudioEfficientConformerInterCTC(device="cpu", causal=True,
                                           left_context=LEFT, **SMALL)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    return jmodel, port


def _stream(st, audio, push):
    st.collect_logits = True
    partials = [st.push(audio[s: s + push])["text"]
                for s in range(0, len(audio), push)]
    fin = st.finish()
    return partials, fin, np.concatenate(st.logits_chunks)[:st._o_total]


@pytest.mark.parametrize("n,push", [(41000, 5000), (20800, 3333)])
def test_causal_transcriber_matches_jax_and_offline(causal, n, push):
    """Ragged pushes of audio not aligned to the chunk: the steps are
    ceil((n // 160 + 1) / 16), the output frames od^3(n // 160 + 1); the
    concatenated logits within 2e-3 of the JAX transcriber's (identical
    tokens) and within 2e-4 of the port's offline causal forward (the
    first L frames cover the caches' warm-up, the end the reflection at
    finish); every partial a prefix of the final text; the caches back at
    L >> stage keys."""
    jmodel, port = causal
    audio = (np.random.RandomState(n).randn(n) * 0.1).astype(np.float32)
    jst_ = jcs.CausalStreamingTranscriber(jmodel, _IdDec(), chunk_frames=16)
    _, jfin, want = _stream(jst_, audio, push)
    st = CausalStreamingTranscriber(port, CTCGreedySearchDecoder(),
                                    chunk_frames=16)
    partials, fin, got = _stream(st, audio, push)
    n_out = _od(_od(_od(n // 160 + 1)))
    assert got.shape == want.shape == (n_out, 32)
    assert len(st.push_latencies) == -(-(n // 160 + 1) // 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert st._tokens == jst_._tokens and st._tokens
    with torch.no_grad():
        logits, lengths = port(t(audio[None]),
                               torch.tensor([n], dtype=torch.int32))["outputs"]
    assert int(lengths[0]) == n_out
    np.testing.assert_allclose(got, logits[0].numpy(), rtol=0, atol=2e-4)
    assert st._tokens == _collapse_host(logits[0].argmax(-1))
    assert fin["final"] and fin["text"] == jfin["text"]
    assert all(fin["text"].startswith(p) for p in partials)
    for block, p in zip(st._state["blocks"],
                        port.encoder.back_end.stream_plan()):
        assert block["att"]["K"].shape == (1, LEFT >> p["stage_id"],
                                           p["dim_model"])
        assert block["conv"].shape == (1, p["dim_expand"], 14)
    with pytest.raises(RuntimeError):
        st.push(audio[:100])


def test_causal_transcriber_commits_grow_and_needs_causal(causal):
    """Committed frames only grow push by push; a bidirectional model and a
    chunk that is no multiple of 8 are refused."""
    _, port = causal
    audio = (np.random.RandomState(2).randn(24000) * 0.1).astype(np.float32)
    st = CausalStreamingTranscriber(port, _IdDec(), chunk_frames=8)
    frames = [st.push(audio[s: s + 3200])["committed_frames"]
              for s in range(0, len(audio), 3200)]
    assert frames == sorted(frames) and frames[-1] > 0
    with pytest.raises(ValueError):
        CausalStreamingTranscriber(port, _IdDec(), chunk_frames=12)
    offline = AudioEfficientConformerInterCTC(device="cpu", **SMALL)
    with pytest.raises(ValueError):
        CausalStreamingTranscriber(offline, _IdDec())


def test_causal_transcriber_puts_a_training_model_in_eval(causal):
    """A model handed over in train mode (as a Trainer leaves it) is put in
    eval mode: the streamed logits are the offline eval forward's (2e-4),
    not those of per-chunk batch statistics and dropout."""
    _, port = causal
    n = 20800
    audio = (np.random.RandomState(5).randn(n) * 0.1).astype(np.float32)
    port.train()
    st = CausalStreamingTranscriber(port, _IdDec(), chunk_frames=16)
    assert not any(m.training for m in port.modules())
    _, _, got = _stream(st, audio, 3333)
    with torch.no_grad():
        logits = port(t(audio[None]),
                      torch.tensor([n], dtype=torch.int32))["outputs"][0]
    np.testing.assert_allclose(got, logits[0].numpy(), rtol=0, atol=2e-4)


# --------------------------------------------- the bidirectional transcriber
TEXTS = ["the cat sat on the mat",
         "a quick brown fox jumps over the lazy dog"]


@pytest.fixture(scope="module")
def bidir(tmp_path_factory):
    """The small AO model (patch attention, flash in the regular stages:
    its plain version on the CPU) with a head whose argmax lands on real
    pieces, and a greedy decoder with a tokenizer."""
    tok_path = str(tmp_path_factory.mktemp("tok") / "tok.json")
    tok = Tokenizer(train_bpe(TEXTS * 4, vocab_size=32))
    tok.save(tok_path)
    model = AudioEfficientConformerInterCTC(
        device="cpu", use_flash=True, generator=torch.Generator().manual_seed(1),
        **SMALL)
    with torch.no_grad():
        randomize_batch_stats(model, torch.Generator().manual_seed(2))
        good = sorted({i for w in ("the", "cat", "fox", "mat")
                       for i in tok.encode(w)})
        bias = torch.full((32,), -20.0)
        bias[good] = torch.randn(len(good),
                                 generator=torch.Generator().manual_seed(3)) * 2
        model.encoder.head.bias.copy_(bias)
    return model, CTCGreedySearchDecoder(tok_path)


def test_streaming_final_matches_offline_collapse_host(bidir):
    """Unbounded, 200 ms pushes of 3 s: the final text equals the offline
    greedy decode of the whole utterance in the same bucket; partials come
    along the way."""
    model, dec = bidir
    audio = (np.random.RandomState(7).randn(3 * 16000) * 0.1).astype(
        np.float32)
    st = StreamingTranscriber(model, dec, hop_seconds=0.5)
    partials = [st.push(audio[s: s + 3200])["text"]
                for s in range(0, len(audio), 3200)]
    final = st.finish()
    pad = np.zeros((1, st._bucket(len(audio))), np.float32)
    pad[0, :len(audio)] = audio
    with torch.no_grad():
        out = model(t(pad), torch.tensor([len(audio)], dtype=torch.int32))
    offline = dec(dec.device_fn(out["outputs"]))[0]
    assert offline != "" and final["final"]
    assert final["text"] == offline
    assert len(partials) == 15 and any(p for p in partials)
    with pytest.raises(RuntimeError):
        st.push(audio[:100])


def test_streaming_windowed_bounded_and_monotonic(bidir):
    """Windowed (3 s window, 0.5 s margin) over 8 s in 500 ms pushes: the
    buffer stays within window + one push, commits only grow and carry
    real tokens."""
    model, dec = bidir
    audio = (np.random.RandomState(11).randn(8 * 16000) * 0.1).astype(
        np.float32)
    st = StreamingTranscriber(model, dec, hop_seconds=0.5, window_seconds=3.0,
                              commit_margin_seconds=0.5)
    committed = []
    for s in range(0, len(audio), 8000):
        r = st.push(audio[s: s + 8000])
        assert r["buffered_seconds"] <= 3.0 + 0.5 + 1e-6
        committed.append(len(st._committed))
    final = st.finish()
    assert committed == sorted(committed) and committed[-1] > 0
    assert len(st._buffer) <= 3.0 * 16000 + 8000
    assert final["text"] != ""


def test_streaming_windowed_giant_push_bounded_buckets(bidir):
    """One push of 20 s with a 3 s window goes hop by hop: every bucket run
    is at most bucket(window + hop)."""
    model, dec = bidir
    audio = (np.random.RandomState(13).randn(20 * 16000) * 0.1).astype(
        np.float32)
    st = StreamingTranscriber(model, dec, hop_seconds=0.5, window_seconds=3.0,
                              commit_margin_seconds=0.5)
    r = st.push(audio)
    assert r["buffered_seconds"] <= 3.0 + 0.5 + 1e-6
    cap = st._bucket(st.window + st.hop)
    assert st._fwd_cache and all(b <= cap for b in st._fwd_cache)
    assert sum(st._fwd_cache.values()) == 40
    assert isinstance(st.finish()["text"], str)


def test_streaming_transcriber_puts_a_training_model_in_eval(bidir):
    """A model handed over in train mode is put in eval mode: the final
    text is the offline eval forward's greedy decode."""
    model, dec = bidir
    audio = (np.random.RandomState(17).randn(2 * 16000) * 0.1).astype(
        np.float32)
    model.train()
    st = StreamingTranscriber(model, dec, hop_seconds=0.5)
    assert not any(m.training for m in model.modules())
    for s in range(0, len(audio), 3200):
        st.push(audio[s: s + 3200])
    final = st.finish()
    pad = np.zeros((1, st._bucket(len(audio))), np.float32)
    pad[0, :len(audio)] = audio
    with torch.no_grad():
        out = model(t(pad), torch.tensor([len(audio)], dtype=torch.int32))
    offline = dec(dec.device_fn(out["outputs"]))[0]
    assert offline != "" and final["text"] == offline


# ------------------------------- the windowed transcriber against the JAX one
def _envelope_noise(seed: int, seconds: int) -> np.ndarray:
    """Noise whose loudness changes every 250 ms, so the frames' argmax
    moves between blank and pieces."""
    rng = np.random.RandomState(seed)
    env = np.repeat(rng.uniform(0.01, 0.3, size=seconds * 4), 4000)
    return (rng.randn(seconds * 16000) * env).astype(np.float32)


@pytest.fixture(scope="module")
def windowed_pair():
    """The small bidirectional AO model in JAX with seeded variables (set,
    not built) and the port model carrying them, with a head bias that
    keeps the argmax on the blank (bias 0) and real pieces (noise of 0.3)
    and off the unused ids (-20), and a decoder stand-in with a
    tokenizer."""
    tok = Tokenizer(train_bpe(TEXTS * 4, vocab_size=32))
    jmodel = jzoo.AudioEfficientConformerInterCTC(**SMALL)
    jmodel.compile(losses=JCTCLoss(zero_infinity=True, assert_shorter=False))
    args = (np.zeros((1, 16000), np.float32), np.array([16000], np.int32))
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    params, stats = random_variables(shapes, seed=4)
    good = sorted({i for w in ("the", "cat", "fox", "mat")
                   for i in tok.encode(w)} - {0})
    bias = np.full((32,), -20.0, np.float32)
    bias[good] = np.random.RandomState(3).randn(len(good)) * 0.3
    bias[0] = 0.0
    params["encoder"]["head"]["bias"] = bias
    jmodel.params, jmodel.batch_stats, jmodel.built = params, stats, True
    port = AudioEfficientConformerInterCTC(device="cpu", **SMALL)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    return jmodel, port, _TokDec(tok)


def _run_windowed(st, pushes):
    """Every push's result (the hops of a giant push included) with the
    commits and the carried id after it, the final text, the commits and
    the forwards per length bucket."""
    log, buckets = [], {}
    push, forward = st.push, st._forward_preds

    def recording_push(pcm):
        out = push(pcm)
        log.append((out["text"], out["buffered_seconds"],
                    list(st._committed), int(st._carry)))
        return out

    def counting_forward(audio):
        b = st._bucket(len(audio))
        buckets[b] = buckets.get(b, 0) + 1
        return forward(audio)

    st.push, st._forward_preds = recording_push, counting_forward
    for pcm in pushes:
        st.push(pcm)
    return log, st.finish()["text"], list(st._committed), buckets


@pytest.mark.parametrize("case", ["pushes", "giant"])
def test_windowed_transcriber_matches_jax(windowed_pair, monkeypatch, case):
    """Windowed (3 s window, 0.5 s hop and margin) on the same weights as
    the JAX `StreamingTranscriber`: 8 s in 500 ms pushes, or 12 s in one
    push that goes hop by hop. Every partial, the commits and the carried
    id after every push, the final text and the forwards per length bucket
    are identical; the run made blank-run cuts and forced cuts, and
    committed real tokens."""
    jmodel, port, dec = windowed_pair
    if case == "pushes":
        audio = _envelope_noise(11, 8)
        pushes = [audio[s: s + 8000] for s in range(0, len(audio), 8000)]
    else:
        pushes = [_envelope_noise(13, 12)]
    cuts = []

    def recording_cut(*args, **kwargs):
        cuts.append(_find_blank_cut(*args, **kwargs))
        return cuts[-1]

    monkeypatch.setattr(pst, "_find_blank_cut", recording_cut)
    kw = dict(hop_seconds=0.5, window_seconds=3.0, commit_margin_seconds=0.5)
    want = _run_windowed(jst.StreamingTranscriber(jmodel, dec, **kw), pushes)
    got = _run_windowed(StreamingTranscriber(port, dec, **kw), pushes)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    assert min(cuts) == -1 and max(cuts) > 0
    assert got[2] and got[1] != ""
    assert max(got[3]) <= StreamingTranscriber(port, dec, **kw)._bucket(
        int(3.5 * 16000))
