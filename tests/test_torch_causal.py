"""The port's causal audio path vs the JAX package: the relative positional
encoding, the `rel_to_abs` skew, Transformer-XL attention, the causal band
mask over the strided stages, and the causal audio encoder (eval, a train
step and its causality).

Sizes are small: blocks (1, 1, 1), vocab 16, left context 8 stage-1 frames,
B = 2 utterances of 1.7 s and 1 s, fp32 on the CPU, weights drawn with numpy
for the JAX variables' shapes (`tests/test_torch_support.py`). Tolerances:
the encoding and the skew 1e-6, modules 1e-4, the model's logits 2e-3 with
identical greedy ids; the train step as `tests/test_torch_train_step*.py`
holds it (losses 1e-4 relative, every gradient leaf 2e-3 of its largest
entry plus 1e-7, updated BN statistics 1e-5), the port's fused
convolution module (with `pad_lo` = 14) and fused FFN through their plain
versions against the JAX step with its Pallas kernels in interpret mode;
the bf16 offline forward against the JAX package's bf16 forward on tone
audio with silent stretches, 3e-2 of the largest fp32 logit.
Nothing in `avec_tpu/` changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.ops import attention as jatt
from avec_tpu.ops import masks as jmasks
from avec_tpu.ops import pos_embeddings as jpos
from avec_tpu.ops.ctc import ctc_greedy_collapse as jax_collapse
from avec_tpu.train import losses as jlosses
from avec_tpu_torch.convert import grads_to_jax_layout, params_from_jax
from avec_tpu_torch.models.conformer import ConvolutionModule
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       randomize_batch_stats)
from avec_tpu_torch.ops import masks, pos_embeddings
from avec_tpu_torch.ops.attention import (RelPosMultiHeadSelfAttention,
                                          rel_to_abs)
from avec_tpu_torch.ops.batch_norm import launches as bn_launches
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import Trainer

from test_torch_support import init_variables, random_variables, t
from test_torch_train_step import _leaves, no_jax_noise  # noqa: F401
from test_torch_train_step_conv import jax_fused_conv  # noqa: F401
from test_torch_train_step_fused import jax_fused  # noqa: F401

torch.set_num_threads(1)

CAUSAL = dict(vocab_size=16, num_blocks=(1, 1, 1), interctc_blocks=(1, 2),
              causal=True, left_context=8)
WEIGHTS = [0.25, 0.25, 0.5]          # onto ctc_0, ctc_1, outputs (sorted)


@pytest.mark.parametrize("seq_len,dim,causal,hidden", [
    (7, 180, False, 0), (7, 180, True, 0), (5, 11, False, 3),
    (5, 11, True, 2), (301, 360, True, 0), (76, 360, False, 0)])
def test_relative_pos_encoding_matches_jax(seq_len, dim, causal, hidden):
    """Interleaved sin / cos, the odd width's zero column, the causal and
    hidden-length position ranges."""
    got = pos_embeddings.relative_pos_encoding(seq_len, dim, causal, hidden)
    want = np.asarray(jpos.relative_pos_encoding(seq_len, dim, causal,
                                                 hidden))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if dim % 2:
        assert not got[..., -1].any()
    absolute = pos_embeddings.sinusoidal_pos_encoding(seq_len, dim)
    np.testing.assert_allclose(
        absolute.numpy(), np.asarray(jpos.sinusoidal_pos_encoding(seq_len,
                                                                  dim)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t1,hidden", [(7, 0), (7, 3), (1, 0), (9, 2)])
def test_rel_to_abs_matches_jax(causal, t1, hidden):
    """Odd T, t2 != t1: equal to the JAX skew, and every absolute score is
    the relative score of its distance: out[i, j] = in[i, T - 1 - i + j]
    for every key j at or before query i (relative index r holds position
    T + Th - 1 - r; key j of query i is at distance i + Th - j), and also
    after it without `causal`."""
    t2 = hidden + t1 if causal else hidden + 2 * t1 - 1
    scores = np.random.RandomState(t1 + hidden).randn(2, 3, t1, t2)
    scores = scores.astype(np.float32)
    got = rel_to_abs(t(scores), causal).numpy()
    want = np.asarray(jatt.rel_to_abs(jnp.asarray(scores), causal))
    assert got.shape == want.shape == (2, 3, t1, hidden + t1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for i in range(t1):
        keys = range(hidden + i + 1) if causal else range(hidden + t1)
        for j in keys:
            np.testing.assert_array_equal(got[:, :, i, j],
                                          scores[:, :, i, t1 - 1 - i + j])


def _lengths_mask(t_len, lengths, left_context):
    return (masks.make_mask(t_len, torch.tensor(lengths),
                            left_context=left_context, right_context=0),
            jmasks.make_mask(t_len, jnp.asarray(lengths),
                             left_context=left_context, right_context=0))


@pytest.mark.parametrize("causal", [False, True])
def test_xl_attention_matches_jax(causal):
    """RelPosMultiHeadSelfAttention (u, v, pos_layer) at T = 9, D = 24,
    4 heads, under the causal band mask of left context 3 and key
    padding."""
    d, heads, t_len = 24, 4, 9
    x = np.random.RandomState(5).randn(2, t_len, d).astype(np.float32)
    jmod = jatt.RelPosMultiHeadSelfAttention(dim_model=d, num_heads=heads,
                                             causal=causal)
    params, _ = init_variables(jmod, jnp.asarray(x), seed=4)
    assert {"u", "v", "pos_layer"} <= set(params)
    port = RelPosMultiHeadSelfAttention(d, heads, causal=causal)
    port.load_state_dict(params_from_jax(params), strict=True)
    mask, jmask = _lengths_mask(t_len, [9, 6], 3)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 mask=jmask))
    with torch.no_grad():
        got = port(t(x), mask=mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_causal_band_mask_over_three_strided_stages_matches_jax():
    """make_mask with a left context and right context 0, combined with the
    padding mask, then restrided per stage (downsample_mask), three times;
    the band's left context halves with each stride."""
    t_len, lengths, left = 61, [61, 44, 17], 8
    mask, jmask = _lengths_mask(t_len, lengths, left)
    for stage in range(4):
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        band = mask[0, 0].numpy()          # the full-length utterance
        i, lc = band.shape[0] - 1, left // 2 ** stage
        assert band[i, i - lc] and not band[i, i - lc - 1]
        assert not band[0, 1]
        mask = masks.downsample_mask(mask, 2)
        jmask = jmasks.downsample_mask(jmask, 2)


def _audio_batch(lens=(27200, 16000), seed=3):
    rng = np.random.RandomState(seed)
    alen = np.asarray(lens, np.int32)
    audio = (rng.randn(len(alen), int(alen.max())) * 0.1).astype(np.float32)
    labels = rng.randint(1, 16, size=(len(alen), 5)).astype(np.int32)
    return {"inputs": [audio, alen],
            "targets": (labels, np.array([5, 3], np.int32))}


@pytest.fixture(scope="module")
def causal():
    jmodel = jzoo.AudioEfficientConformerInterCTC(**CAUSAL)
    args = (np.zeros((1, 16000), np.float32), np.array([16000], np.int32))
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    params, stats = random_variables(shapes, seed=0)
    return jmodel, params, stats


def _port(params, stats, **route):
    model = AudioEfficientConformerInterCTC(device="cpu", **CAUSAL, **route)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    return model


def test_causal_encoder_eval_matches_jax(causal):
    """The causal stem ("same" in frequency, "causal" in time), XL attention
    in all three stages and causal convolution modules: logits 2e-3,
    identical greedy ids."""
    jmodel, params, stats = causal
    inputs = _audio_batch()["inputs"]
    out = jax.jit(lambda p, s, *a: jmodel.apply_net(p, s, list(a), False)[0])(
        params, stats, *inputs)
    want_logits, want_len = out["outputs"]
    port = _port(params, stats)
    convs = [m for m in port.modules() if isinstance(m, ConvolutionModule)]
    assert convs and all(m.padding == "causal" for m in convs)
    assert port.encoder.subsampling_module.layers[0][0].pads == ((1, 1),
                                                                 (2, 0))
    got = port(*(t(a) for a in inputs))
    assert set(got) == set(out) == {"outputs", "ctc_0", "ctc_1"}
    got_logits, got_len = got["outputs"]
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=2e-3)
    toks, tok_len = jax_collapse(jnp.argmax(want_logits, -1), want_len)
    got_toks = got_logits.argmax(-1).numpy()
    for b in range(2):
        ids = [int(v) for k, v in enumerate(got_toks[b, :int(got_len[b])])
               if v and (k == 0 or v != got_toks[b, k - 1])]
        assert ids == np.asarray(toks)[b, :int(tok_len[b])].tolist()
    for key in ("ctc_0", "ctc_1"):
        np.testing.assert_allclose(got[key][0].numpy(),
                                   np.asarray(out[key][0]), rtol=0,
                                   atol=2e-3)


def _jax_step(jmodel, params, stats, batch):
    names = sorted(["outputs", "ctc_0", "ctc_1"])
    jmodel.compile(losses=jlosses.CTCLoss(zero_infinity=True,
                                          assert_shorter=False),
                   loss_weights=WEIGHTS)
    proto = {k: None for k in names}
    jmodel.output_names = names
    jmodel.losses = jmodel.map_to_outputs(proto, jmodel.compiled_losses)
    jmodel.loss_weights = jmodel.map_to_outputs(proto,
                                                jmodel.compiled_loss_weights)
    rngs = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}
    targets = jmodel._map_targets(tuple(jnp.asarray(a)
                                        for a in batch["targets"]))

    def loss_fn(p):
        outputs, new_bs, _, _ = jmodel.apply_net(p, stats, batch["inputs"],
                                                 True, rngs, with_aux=True)
        losses = jmodel._compute_losses(outputs, targets, 0)
        return losses["loss"], (losses, new_bs)

    grads, (losses, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return losses, grads, new_bs


def test_causal_train_step_matches_jax(causal, no_jax_noise, jax_fused_conv):
    """One forward + backward on a ragged batch: the port's fused
    convolution modules at pad_lo = 14 and fused FFN (plain versions)
    against the JAX step through its Pallas kernels (interpret mode); the
    loss weights [0.25, 0.25, 0.5] as AO-Tone-Causal gives them, mapped
    onto the sorted output names in both packages."""
    from avec_tpu_torch.convert import state_to_jax

    jmodel, params, stats = causal
    batch = _audio_batch()
    want_losses, want_grads, want_bs = _jax_step(jmodel, params, stats, batch)
    model = _port(params, stats, fused_conv=True, fused_ffn=True,
                  fused_att=True)
    assert model.kernel_launches_per_step() == {
        "fused_ffn_fwd": 6, "fused_ffn_bwd": 6, "fused_conv_stats": 1,
        "fused_conv_fwd": 1, "fused_conv_bwd1": 1, "fused_conv_bwd2": 1,
        **bn_launches(3)}
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True), loss_weights=WEIGHTS)
    trainer.model.set_regularization(False)
    losses, grads = trainer.loss_and_grads(batch)
    assert set(losses) == set(want_losses)
    for k, w in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(w), rel=1e-4), k
    got = dict(_leaves(grads_to_jax_layout(grads, params)))
    want = dict(_leaves(want_grads))
    assert got.keys() == want.keys()
    assert any(k.endswith("/u") for k in want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 2e-3 * np.abs(w).max() + 1e-7, (k, err)
    _, got_bs = state_to_jax(trainer.model.state_dict(), params, stats)
    for (k, g), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
        assert k == k2
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


def test_causal_encoder_is_causal():
    """tests/test_causal_streaming.py:50 on the port: changing the audio
    after sample S leaves every output frame up to (S - 256) // 1280
    bit-identical (frame o, 12.5 Hz, depends on samples up to 1280 o + 256,
    the fbank window's centre lookahead), and changes later frames by more
    than 1e-3."""
    model = AudioEfficientConformerInterCTC(
        device="cpu", generator=torch.Generator().manual_seed(3), **CAUSAL)
    with torch.no_grad():
        randomize_batch_stats(model, torch.Generator().manual_seed(4))
    rng = np.random.RandomState(0)
    n, s = 25600, 12800
    a1 = (rng.randn(1, n) * 0.1).astype(np.float32)
    a2 = a1.copy()
    a2[0, s:] += rng.randn(n - s).astype(np.float32)
    lens = torch.tensor([n], dtype=torch.int32)
    l1 = model(t(a1), lens)["outputs"][0][0]
    l2 = model(t(a2), lens)["outputs"][0][0]
    safe = (s - 256) // 1280
    assert torch.equal(l1[:safe + 1], l2[:safe + 1])
    assert float((l1[safe + 2:] - l2[safe + 2:]).abs().max()) > 1e-3



def _tone_audio(n: int, seed: int) -> np.ndarray:
    """Tones that change frequency and loudness every 0.12 s, silent
    stretches among them, as chip_smoke.py's requests make them."""
    rng = np.random.RandomState(seed)
    seg = 1920
    freq = np.repeat(rng.uniform(100, 4000, n // seg + 1), seg)[:n]
    amp = np.repeat(rng.uniform(0.0, 0.5, n // seg + 1), seg)[:n]
    return (amp * np.sin(2 * np.pi * np.cumsum(freq) / 16000)).astype(
        np.float32)


def test_causal_bf16_offline_forward_matches_jax(causal):
    """The offline causal forward in bf16 against the JAX package's bf16
    forward on the same weights and samples: every output within 3e-2 of
    the largest fp32 logit (the bf16 tolerance of test_torch_ffn.py's
    kernel twins), lengths equal. Both packages cast the float samples to
    bf16 before the net (avec_tpu/train/model.py:146-151), which moves the
    near-silent log-mels: that forward is far from the fp32 one (0.65 of a
    largest logit 1.28 here) in both alike, within the same 3e-2. The fbank
    of the fp32 samples, then the cast (a forward hook on the preprocessing;
    the streaming transcribers' order) stays within 3e-2 of the fp32
    forward."""
    jmodel, params, stats = causal
    n = 27200
    audio = np.stack([_tone_audio(n, 5), _tone_audio(n, 6)])
    alen = np.array([n, 20000], np.int32)

    def jax_forward(dtype):
        jmodel._compute_dtype = dtype
        try:
            return jax.jit(lambda p, s, a, l: jmodel.apply_net(
                p, s, [a, l], False)[0])(params, stats, audio, alen)
        finally:
            jmodel._compute_dtype = jnp.float32

    want32, want = jax_forward(jnp.float32), jax_forward(jnp.bfloat16)
    port = _port(params, stats)
    with torch.no_grad():
        got32 = port(t(audio), t(alen))["outputs"][0].numpy()
        got = port(t(audio).to(torch.bfloat16), t(alen))
        hook = port.encoder.preprocessing.register_forward_hook(
            lambda m, i, o: (o[0].to(torch.bfloat16), o[1]))
        fbank_first = port(t(audio), t(alen))["outputs"][0]
        hook.remove()
    w32 = np.asarray(want32["outputs"][0])
    big = float(np.abs(w32).max())
    for key in ("outputs", "ctc_0", "ctc_1"):
        assert got[key][0].dtype == torch.bfloat16
        g = got[key][0].float().numpy()
        w = np.asarray(want[key][0].astype(jnp.float32))
        assert np.abs(g - w).max() <= 3e-2 * big, key
        np.testing.assert_array_equal(got[key][1].numpy(),
                                      np.asarray(want[key][1]))
    gap = np.abs(got["outputs"][0].float().numpy() - got32).max()
    jax_gap = np.abs(np.asarray(want["outputs"][0].astype(jnp.float32))
                     - w32).max()
    assert abs(gap - jax_gap) <= 3e-2 * big
    assert fbank_first.dtype == torch.bfloat16
    assert np.abs(fbank_first.float().numpy() - w32).max() <= 3e-2 * big
