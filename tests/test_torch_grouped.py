"""The port's grouped and N-d attention against the JAX package: the grouped
relative encoding, `GroupedRelPosMultiHeadSelfAttention` (sequence lengths
a multiple of the group and not, ragged masks, a key/value cache),
`NdMultiHeadAttention` on a 2-d grid, and the audio-only model with
att_type "grouped" (eval logits, and one train step's losses and gradients
on an equal-length batch).

Sizes are small (d 16-24, 2 heads, blocks (1, 1, 1)), fp32 on the CPU,
weights drawn with numpy for the JAX variables' shapes and carried into the
port by `params_from_jax`. Tolerances: the encoding 1e-6; modules 1e-4; the
model's logits 2e-3 with identical greedy ids; the train step's losses
1e-4 relative and every gradient leaf 2e-3 of its largest entry plus 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.ops import attention as jatt
from avec_tpu.ops import pos_embeddings as jpe
from avec_tpu.train import losses as jlosses
from avec_tpu_torch.convert import grads_to_jax_layout, params_from_jax
from avec_tpu_torch.models import zoo
from avec_tpu_torch.ops import attention as patt
from avec_tpu_torch.ops import pos_embeddings as ppe
from avec_tpu_torch.ops.batch_norm import launches as bn_launches
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import Trainer

from test_torch_support import init_variables, port_state, t
from test_torch_train_step import _leaves, no_jax_noise  # noqa: F401
from test_torch_zoo import _greedy_ids

torch.set_num_threads(1)

AO = dict(vocab_size=16, num_blocks=(1, 1, 1), interctc_blocks=(1, 2))


@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hidden_len", [0, 6])
def test_grouped_pos_encoding_matches_jax(group, causal, hidden_len):
    """Positions of the grouped table (an even G repeats position 0 in the
    full-context form; the causal form takes hidden_len), 1e-6."""
    want = np.asarray(jpe.grouped_relative_pos_encoding(
        12, 16, group, causal, hidden_len=hidden_len))
    got = ppe.grouped_relative_pos_encoding(12, 16, group, causal,
                                            hidden_len=hidden_len)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    again = ppe.grouped_relative_pos_encoding(12, 16, group, causal,
                                              hidden_len=hidden_len)
    assert again is got          # one table per arguments and device


def _grouped_pair(group, causal, d=24, heads=2, seed=0):
    jmod = jatt.GroupedRelPosMultiHeadSelfAttention(
        dim_model=d, num_heads=heads, group_size=group, causal=causal)
    x0 = np.zeros((2, 9, d), np.float32)
    params, _ = init_variables(jmod, x0, seed=seed)
    port = patt.GroupedRelPosMultiHeadSelfAttention(d, heads, group_size=group,
                                                    causal=causal)
    port.load_state_dict(port_state(params), strict=True)
    return jmod, params, port


def _key_mask(lengths, t_len):
    return (np.arange(t_len)[None, :]
            < np.asarray(lengths)[:, None])[:, None, None, :]


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("t_len", [9, 10])
@pytest.mark.parametrize("masked", ["none", "ragged", "full"])
def test_grouped_attention_matches_jax(group, t_len, masked):
    """Grouped attention with T a multiple of G and not: zero padding, the
    mask built for padded keys, a ragged key mask or a full (B, 1, T, T)
    band mask padded and subsampled [::G, ::G], the output unfolded and cut
    to T; 1e-4."""
    jmod, params, port = _grouped_pair(group, causal=False)
    x = np.random.RandomState(t_len).randn(2, t_len, 24).astype(np.float32)
    mask = None
    if masked == "ragged":
        mask = _key_mask([t_len, 5], t_len)
    elif masked == "full":
        band = np.abs(np.arange(t_len)[:, None] - np.arange(t_len)[None]) <= 4
        mask = band[None, None] & _key_mask([t_len, 7], t_len)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask))
    got = port(t(x), None if mask is None else t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("hidden_len", [4, 6])
@pytest.mark.parametrize("causal", [False, True])
def test_grouped_attention_with_hidden_matches_jax(group, hidden_len, causal):
    """With a key/value cache: the first Th % G cached frames left out of
    the keys, the returned cache the whole of it followed by this call's
    keys and values; out 1e-4, cache exact."""
    jmod, params, port = _grouped_pair(group, causal=causal, seed=1)
    rng = np.random.RandomState(hidden_len)
    x = rng.randn(2, 6, 24).astype(np.float32)
    hidden = {k: rng.randn(2, hidden_len, 24).astype(np.float32)
              for k in ("K", "V")}
    want, want_h = jmod.apply(
        {"params": params}, jnp.asarray(x), None,
        hidden={k: jnp.asarray(v) for k, v in hidden.items()},
        return_hidden=True)
    got, got_h = port(t(x), None, hidden={k: t(v) for k, v in hidden.items()},
                      return_hidden=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    for k in ("K", "V"):
        assert got_h[k].shape[1] == hidden_len + 6
        np.testing.assert_allclose(got_h[k].numpy(), np.asarray(want_h[k]),
                                   rtol=0, atol=1e-6)


def test_nd_attention_matches_jax():
    """NdMultiHeadAttention on a (B, 3, 4, C) grid: the 12 positions
    flattened, attended with a key mask, restored; 1e-4."""
    jmod = jatt.NdMultiHeadAttention(dim_model=16, num_heads=2)
    x = np.random.RandomState(2).randn(2, 3, 4, 16).astype(np.float32)
    params, _ = init_variables(jmod, x)
    port = patt.NdMultiHeadAttention(16, 2)
    port.load_state_dict(port_state(params), strict=True)
    mask = _key_mask([12, 7], 12)
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    got = port(t(x), t(mask))
    assert tuple(got.shape) == (2, 3, 4, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


def test_att_dict_has_the_grouped_and_nd_classes():
    assert set(patt.att_dict) == set(jatt.att_dict)
    spec = {"class": "GroupedRelPosMultiHeadSelfAttention",
            "params": {"num_heads": 4, "group_size": 3, "causal": False,
                       "attn_drop_rate": 0.0, "max_pos_encoding": 10000}}
    att = patt.make_attention(180, spec)
    assert type(att) is patt.GroupedRelPosMultiHeadSelfAttention
    assert att.dim_head == 135


@pytest.fixture(scope="module")
def grouped_ao():
    jmodel = jzoo.AudioEfficientConformerInterCTC(att_type="grouped", **AO)
    params, stats = init_variables(
        jmodel.net, np.zeros((1, 16000), np.float32),
        np.array([16000], np.int32), training=False)
    return jmodel, params, stats


def _audio(lens, seed=3):
    rng = np.random.RandomState(seed)
    alen = np.asarray(lens, np.int32)
    audio = (rng.randn(len(alen), int(alen.max())) * 0.1).astype(np.float32)
    for i, n in enumerate(alen):
        audio[i, n:] = 0.0
    return audio, alen


def test_grouped_ao_model_matches_jax(grouped_ao):
    """The AO model with att_type "grouped" (groups 3, 1, 1) on a ragged
    batch: every output's logits 2e-3 and lengths equal, identical greedy
    ids; no kernel on its attention route."""
    jmodel, params, stats = grouped_ao
    audio, alen = _audio((27200, 16000))
    out = jax.jit(lambda p, s, a, n: jmodel.apply_net(p, s, [a, n], False)[0])(
        params, stats, audio, alen)
    port = zoo.AudioEfficientConformerInterCTC(device="cpu",
                                               att_type="grouped", **AO)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    groups = [m.group_size for m in port.modules()
              if isinstance(m, patt.GroupedRelPosMultiHeadSelfAttention)]
    assert groups == [3, 1, 1]
    assert port.kernel_launches_per_step() == bn_launches(4)
    with torch.no_grad():
        got = port(t(audio), t(alen))
    assert set(got) == set(out)
    for key in got:
        np.testing.assert_array_equal(got[key][1].numpy(),
                                      np.asarray(out[key][1]))
        np.testing.assert_allclose(got[key][0].numpy(),
                                   np.asarray(out[key][0]), rtol=0, atol=2e-3)
    assert (_greedy_ids(got["outputs"][0].numpy(), got["outputs"][1])
            == _greedy_ids(*out["outputs"]))


def test_grouped_ao_train_step_matches_jax(grouped_ao, no_jax_noise):
    """One forward + backward on an equal-length batch, dropout and
    SpecAugment off, the model's loss weights mapped onto the sorted output
    names in both packages: every loss 1e-4 relative, every gradient leaf
    2e-3 of its largest entry plus 1e-7."""
    jmodel, params, stats = grouped_ao
    audio, alen = _audio((20000, 20000), seed=4)
    labels = np.random.RandomState(5).randint(1, 16, (2, 4)).astype(np.int32)
    batch = {"inputs": [audio, alen],
             "targets": (labels, np.array([4, 3], np.int32))}
    names = ["ctc_0", "ctc_1", "outputs"]
    jmodel.compile(losses=jlosses.CTCLoss(zero_infinity=True,
                                          assert_shorter=False),
                   loss_weights=[0.25, 0.25, 0.5])
    proto = {k: None for k in names}
    jmodel.output_names = names
    jmodel.losses = jmodel.map_to_outputs(proto, jmodel.compiled_losses)
    jmodel.loss_weights = jmodel.map_to_outputs(proto,
                                                jmodel.compiled_loss_weights)
    targets = jmodel._map_targets(tuple(jnp.asarray(a)
                                        for a in batch["targets"]))
    rngs = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}

    def loss_fn(p):
        outputs, new_bs, _, _ = jmodel.apply_net(p, stats, batch["inputs"],
                                                 True, rngs, with_aux=True)
        losses = jmodel._compute_losses(outputs, targets, 0)
        return losses["loss"], losses

    want_grads, want_losses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    model = zoo.AudioEfficientConformerInterCTC(
        device="cpu", att_type="grouped", fused_att=False, fused_conv=False,
        fused_ffn=False, **AO)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True),
                      loss_weights=[0.25, 0.25, 0.5])
    model.set_regularization(False)
    losses, grads = trainer.loss_and_grads(batch)
    assert set(losses) == set(want_losses)
    for k, w in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(w), rel=1e-4), k
    got = dict(_leaves(grads_to_jax_layout(grads, params)))
    want = dict(_leaves(want_grads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 2e-3 * np.abs(w).max() + 1e-7, (k, err)


def test_causal_grouped_builds_what_jax_builds():
    """causal=True replaces the attention spec with the causal
    Transformer-XL one in both packages, whatever att_type says: the
    variables are the same tree."""
    kw = dict(vocab_size=16, num_blocks=(1, 1, 1), interctc_blocks=(),
              causal=True, left_context=8)
    jmodel = jzoo.AudioEfficientConformerInterCTC(att_type="grouped", **kw)
    params, stats = init_variables(
        jmodel.net, np.zeros((1, 16000), np.float32),
        np.array([16000], np.int32), training=False)
    port = zoo.AudioEfficientConformerInterCTC(device="cpu",
                                               att_type="grouped", **kw)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    atts = [type(m) for m in port.modules()
            if isinstance(m, patt.RelPosMultiHeadSelfAttention)]
    assert atts == [patt.RelPosMultiHeadSelfAttention] * 3
