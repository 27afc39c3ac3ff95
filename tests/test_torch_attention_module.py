"""The port's fused attention module (plain version of K2/K2b) vs the JAX
Pallas kernels.

The JAX side is
`avec_tpu.ops.pallas_attention_module.fused_attention_module_3d(...,
interpret=True)`, as the JAX package's own tests run it on the CPU; its
gradients come from `jax.vjp` through the custom VJP, i.e. from the Pallas
backward kernel. The port side is `fused_attention_module_3d` on CPU tensors
(the plain version, differentiated by autograd). Inputs and parameters are
numpy draws from a seed. The port keeps the Linear (out, in) weight layout,
so the five (d, d) kernels are transposed on the way in and their gradients
on the way back.

Tolerances: fp32 forward 3e-5 and gradients 5e-4, absolute and relative (those
of tests/test_pallas_attention_module.py:59-60 and :78-85); bf16 5e-2 of the
largest entry plus 1e-6 (the JAX wrapper also rounds its positional gradients
to bf16).
With dropout on, both sides draw the same hash mask from the same seed, so
the fp32 tolerances hold and the dropped entries coincide.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models.conformer import AttentionModule as JaxAttentionModule
from avec_tpu.ops.masks import make_mask as jax_make_mask
from avec_tpu.ops.pallas_attention_module import (
    fused_attention_module_3d as jax_fused_attention_module_3d)
from avec_tpu_torch.models.conformer import AttentionModule
from avec_tpu_torch.ops.attention_module import fused_attention_module_3d
from avec_tpu_torch.ops.ffn import dropout_mask
from avec_tpu_torch.ops.masks import make_mask

from test_torch_support import init_variables, port_state, t

torch.set_num_threads(1)

NAMES = ("ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv", "bv",
         "pos_kernel", "pos_bias", "wo", "bo")
MATRICES = ("wq", "wk", "wv", "pos_kernel", "wo")
SHAPES = [(3, 29, 32, 2), (2, 40, 64, 4)]


def _inputs(seed, b, tt, d):
    """x, cotangent and parameters in the JAX layout ((in, out) kernels)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, tt, d).astype(np.float32)
    g = rng.randn(b, tt, d).astype(np.float32)
    u = lambda shape: rng.uniform(-d ** -0.5, d ** -0.5,
                                  size=shape).astype(np.float32)
    p = {n: u((d, d)) if n in MATRICES else u((d,)) for n in NAMES}
    p["ln_scale"] = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    p["ln_bias"] = (0.1 * rng.randn(d)).astype(np.float32)
    return x, g, p


def _lengths(kind, b, tt):
    return {"none": None, "ragged": [tt, tt // 2, 0][:b],
            "short": [tt, tt - 7, tt - 5][:b]}[kind]


def _jax_side(x, g, p, heads, lengths, seed, drop, residual,
              dtype=jnp.float32):
    def fn(x, *params):
        return jax_fused_attention_module_3d(
            x, *params, num_heads=heads,
            lengths=None if lengths is None else jnp.asarray(lengths),
            seed=jnp.asarray([seed], jnp.int32), drop_rate=drop,
            deterministic=False, residual=residual, interpret=True)

    args = (jnp.asarray(x, dtype),) + tuple(jnp.asarray(p[n]) for n in NAMES)
    y, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g, dtype))
    return (np.asarray(y, np.float32),
            [np.asarray(a, np.float32) for a in grads])


def _port_side(x, g, p, heads, lengths, seed, drop, residual,
               dtype=torch.float32):
    xt = t(x).to(dtype).requires_grad_(True)
    params = [t(p[n].T.copy() if n in MATRICES else p[n]) for n in NAMES]
    for a in params:
        a.requires_grad_(True)
    y = fused_attention_module_3d(
        xt, *params, num_heads=heads,
        lengths=None if lengths is None else np.asarray(lengths),
        seed=seed, drop_rate=drop, deterministic=False, residual=residual)
    assert y.dtype == dtype
    y.backward(t(g).to(dtype))
    grads = [xt.grad.float().numpy()]
    for n, a in zip(NAMES, params):
        assert a.grad.dtype == torch.float32
        grads.append(a.grad.numpy().T if n in MATRICES else a.grad.numpy())
    return y.detach().float().numpy(), grads


@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("kind", ["none", "short", "ragged"])
@pytest.mark.parametrize("b,tt,d,heads", SHAPES, ids=["d32", "d64"])
def test_plain_attention_module_matches_pallas_fp32(b, tt, d, heads, kind,
                                                    residual):
    """Forward, dx and all twelve parameter gradients, without lengths, with
    lengths, and with a sequence of length 0 ("ragged"), whose softmax is
    uniform over all keys and whose rows past the length keep their
    gradient."""
    x, g, p = _inputs(1, b, tt, d)
    lengths = _lengths(kind, b, tt)
    want_y, want_g = _jax_side(x, g, p, heads, lengths, 0, 0.0, residual)
    got_y, got_g = _port_side(x, g, p, heads, lengths, 0, 0.0, residual)
    np.testing.assert_allclose(got_y, want_y, atol=3e-5, rtol=3e-5)
    for name, got, want in zip(("x",) + NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    if kind == "ragged":
        past = np.abs(want_g[0][1, tt // 2:]).max()
        assert past > 1e-3                    # rows past the length are live
        assert np.abs(want_g[0][-1]).max() > 1e-3 or b < 3


@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
def test_dropout_masks_and_gradients_match_pallas(residual):
    """Dropout 0.4: the kept outputs are equal, the dropped entries are the
    same ones (entry by entry the port's hash mask with one tile per
    sequence), and the gradients agree."""
    b, tt, d, heads = 3, 29, 32, 2
    x, g, p = _inputs(2, b, tt, d)
    lengths = _lengths("short", b, tt)
    want_y, want_g = _jax_side(x, g, p, heads, lengths, 4321, 0.4, residual)
    got_y, got_g = _port_side(x, g, p, heads, lengths, 4321, 0.4, residual)
    np.testing.assert_allclose(got_y, want_y, atol=3e-5, rtol=3e-5)
    for name, got, want in zip(("x",) + NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    mask = dropout_mask(4321, b * tt, d, 1, 0.6, tile_rows=tt).numpy()
    dropped = (mask == 0.0).reshape(b, tt, d)
    base = x if residual else np.zeros_like(x)
    np.testing.assert_array_equal(want_y == base, dropped)
    np.testing.assert_array_equal(got_y == base, dropped)
    assert 0.3 < dropped.mean() < 0.5


@pytest.mark.parametrize("drop,seed", [(0.0, 0), (0.4, 77)],
                         ids=["nodrop", "drop0.4"])
def test_plain_attention_module_matches_pallas_bf16(drop, seed):
    b, tt, d, heads = 2, 33, 64, 4
    x, g, p = _inputs(3, b, tt, d)
    lengths = [tt, tt - 9]
    want_y, want_g = _jax_side(x, g, p, heads, lengths, seed, drop, True,
                               jnp.bfloat16)
    got_y, got_g = _port_side(x, g, p, heads, lengths, seed, drop, True,
                              torch.bfloat16)
    for name, got, want in zip(("y", "x") + NAMES, [got_y] + got_g,
                               [want_y] + want_g):
        # + 1e-6: the key bias shifts every score of a row alike, so its
        # gradient is analytically zero and holds rounding noise only
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max() + 1e-6, (
            name)


def _att_params(heads, use_flash=False):
    return {"class": "RelPos1dMultiHeadAttention",
            "params": {"num_heads": heads, "use_flash": use_flash}}


def _module_pair(d, heads, drop, x, mask):
    jmod = JaxAttentionModule(dim_model=d, att_params=_att_params(heads),
                              drop_rate=drop, residual=False)
    params, _ = init_variables(jmod, jnp.asarray(x), mask, seed=5)
    port = AttentionModule(d, _att_params(heads), drop, fused_att=True)
    port.load_state_dict(port_state(params, wrap="self_att_module",
                                    strip="self_att_module."))
    return jmod, params, port


def test_module_training_route_matches_jax_module():
    """`AttentionModule(fused_att=True).train()` against the JAX module under
    AVEC_TPU_FUSED_ATT=1 (its Pallas kernels in interpret mode), parameters
    carried over by `params_from_jax`: output and input gradient."""
    b, tt, d, heads = 2, 26, 32, 4
    rng = np.random.RandomState(4)
    x = rng.randn(b, tt, d).astype(np.float32)
    g = rng.randn(b, tt, d).astype(np.float32)
    lengths = np.array([tt, tt - 7], np.int32)
    jmask = jax_make_mask(tt, jnp.asarray(lengths))
    jmod, params, port = _module_pair(d, heads, 0.0, x, jmask)

    def loss(params, x):
        y = jmod.apply({"params": params}, x, mask=jmask, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return (y * g).sum(), y

    os.environ["AVEC_TPU_FUSED_ATT"] = "1"
    try:
        (want_gp, want_gx), want_y = jax.grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    finally:
        del os.environ["AVEC_TPU_FUSED_ATT"]
    port.train()
    xt = t(x).requires_grad_(True)
    # lengths from the mask, as the JAX module derives them
    y = port(xt, mask=make_mask(tt, t(lengths)))
    (y * t(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx),
                               atol=5e-4, rtol=5e-4)
    got_w = port.attention.pos_layer.weight.grad.numpy().T
    want_w = np.asarray(
        want_gp["RelPos1dMultiHeadAttention_0"]["pos_kernel"])
    np.testing.assert_allclose(got_w, want_w, atol=5e-4, rtol=5e-4)
    # the same call with explicit lengths gives the same output
    y2 = port(t(x), mask=make_mask(tt, t(lengths)), lengths=t(lengths))
    assert torch.equal(y2, y.detach())


def test_module_gate_and_eval_route():
    """Eval is bit-identical with the switch on and off; the fused route is
    taken only in training, on a 3-d input, by RelPos1d attention without
    flash, with no mask or a key-padding mask; dropout draws its seed from
    `seed_generator` only when the rate is positive."""
    b, tt, d, heads = 2, 18, 32, 2
    rng = np.random.RandomState(6)
    x = rng.randn(b, tt, d).astype(np.float32)
    _, params, fused = _module_pair(d, heads, 0.3, x, None)
    plain = AttentionModule(d, _att_params(heads), 0.3, fused_att=False)
    plain.load_state_dict(fused.state_dict())
    mask = make_mask(tt, torch.tensor([tt, 5]))
    assert torch.equal(fused(t(x), mask=mask), plain(t(x), mask=mask))
    assert fused.fused_eligible(3, mask) and fused.fused_eligible(3, None)
    assert not plain.fused_eligible(3, mask)
    assert not fused.fused_eligible(4, mask)
    assert not fused.fused_eligible(3, mask.expand(b, 1, tt, tt))
    for spec in (_att_params(heads, use_flash=True),
                 {"class": "RelPosPatch1dMultiHeadAttention",
                  "params": {"num_heads": heads, "patch_size": 3}}):
        assert not AttentionModule(d, spec, 0.3,
                                   fused_att=True).fused_eligible(3, mask)
    os.environ["AVEC_TPU_FUSED_ATT"] = "1"
    try:
        assert AttentionModule(d, _att_params(heads), 0.3).fused_att
    finally:
        del os.environ["AVEC_TPU_FUSED_ATT"]
    assert not AttentionModule(d, _att_params(heads), 0.3).fused_att

    fused.train()
    fused.seed_generator = torch.Generator().manual_seed(3)
    state = fused.seed_generator.get_state()
    dropped = fused(t(x), mask=mask)
    assert 0.2 < float((dropped == 0).float().mean()) < 0.4
    assert not torch.equal(fused.seed_generator.get_state(), state)
    fused.regularize = False
    state = fused.seed_generator.get_state()
    clean = fused(t(x), mask=mask)
    assert torch.equal(fused.seed_generator.get_state(), state)
    fused.eval()
    np.testing.assert_allclose(clean.detach().numpy(),
                               fused(t(x), mask=mask).detach().numpy(),
                               atol=3e-5)
