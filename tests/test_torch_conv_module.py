"""The port's fused convolution module (plain stages of K3/K3b) vs the JAX
Pallas kernels, and the module's fused route vs the JAX module and the
port's own unfused module.

The JAX side is `avec_tpu.ops.pallas_conv_module.fused_conv_module_3d(...,
interpret=True)`, as the JAX package's own tests run it on the CPU; its
gradients come from `jax.vjp` through the custom VJP, i.e. from the Pallas
backward kernels. The port side is `fused_conv_module_3d` on CPU tensors:
the four plain stages and their glue inside the autograd Function. Inputs
and parameters are numpy draws from a seed, in the JAX layout; the port takes
the `Conv` layout (pw1 (2E, d, 1), depthwise (E, 1, k), pw2 (E', E, 1)), so
the three kernels are transposed on the way in and their gradients on the
way back.

Tolerances: fp32 y, mean and var 3e-5, all eleven gradients 5e-4, absolute
and relative (those of tests/test_pallas_conv_module.py:80-118); the
depthwise-bias gradient exactly zero on both sides; bf16 5e-2 of the largest
entry. With dropout on, both sides draw the same hash mask from the same
seed, so the fp32 tolerances hold and the dropped entries coincide. Module
level: output and running statistics 1e-5 against the JAX module under
AVEC_TPU_FUSED_CONV=1; the plain backward against autograd of the port's
unfused module 5e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models.conformer import ConvolutionModule as JaxConvolutionModule
from avec_tpu.ops.pallas_conv_module import (
    fused_conv_module_3d as jax_fused_conv_module_3d)
from avec_tpu_torch.models.conformer import ConvolutionModule
from avec_tpu_torch.ops.conv_module import (conv_module_params,
                                            fused_conv_module_3d)
from avec_tpu_torch.ops.ffn import dropout_mask

from test_torch_support import init_variables, port_state, t

torch.set_num_threads(1)

NAMES = ("ln_scale", "ln_bias", "pw1_k", "pw1_b", "dw_k", "dw_b", "bn_scale",
         "bn_bias", "pw2_k", "pw2_b")
SHAPES = [(64, 64, 15, 3, 40), (48, 96, 7, 2, 33)]      # (d, E, k, B, T)


def _inputs(seed, d, e, k, b, tt):
    """x, cotangent and parameters in the JAX layout (E' = E)."""
    rng = np.random.RandomState(seed)
    u = lambda shape, s: rng.uniform(-s, s, size=shape).astype(np.float32)
    p = {"ln_scale": 1.0 + 0.1 * rng.randn(d), "ln_bias": 0.1 * rng.randn(d),
         "pw1_k": u((1, d, 2 * e), d ** -0.5), "pw1_b": u((2 * e,), d ** -0.5),
         "dw_k": u((k, 1, e), k ** -0.5), "dw_b": u((e,), k ** -0.5),
         "bn_scale": 1.0 + 0.1 * rng.randn(e), "bn_bias": 0.1 * rng.randn(e),
         "pw2_k": u((1, e, e), e ** -0.5), "pw2_b": u((e,), e ** -0.5)}
    p = {n: np.asarray(v, np.float32) for n, v in p.items()}
    x = rng.randn(b, tt, d).astype(np.float32)
    g = rng.randn(b, tt, e).astype(np.float32)
    return x, g, p


def _to_port(name, a):
    """A JAX-layout parameter (or its gradient) in the port's layout."""
    if name in ("pw1_k", "pw2_k"):
        return np.ascontiguousarray(a[0].T[:, :, None])
    if name == "dw_k":
        return np.ascontiguousarray(a.transpose(2, 1, 0))
    return a


def _to_jax(name, a):
    if name in ("pw1_k", "pw2_k"):
        return np.ascontiguousarray(a[:, :, 0].T[None])
    if name == "dw_k":
        return np.ascontiguousarray(a.transpose(2, 1, 0))
    return a


def _jax_side(x, g, p, padding, seed, drop, dtype=jnp.float32):
    def fn(x, *params):
        return jax_fused_conv_module_3d(
            x, *params, seed=jnp.asarray([seed], jnp.int32), padding=padding,
            drop_rate=drop, deterministic=False, interpret=True)

    args = (jnp.asarray(x, dtype),) + tuple(jnp.asarray(p[n]) for n in NAMES)
    (y, mean, var), vjp = jax.vjp(fn, *args)
    grads = vjp((jnp.asarray(g, dtype), jnp.zeros_like(mean),
                 jnp.zeros_like(var)))
    return ([np.asarray(a, np.float32) for a in (y, mean, var)],
            [np.asarray(a, np.float32) for a in grads])


def _port_side(x, g, p, padding, seed, drop, dtype=torch.float32):
    xt = t(x).to(dtype).requires_grad_(True)
    params = [t(_to_port(n, p[n])).requires_grad_(True) for n in NAMES]
    y, mean, var = fused_conv_module_3d(
        xt, *params, seed=seed, padding=padding, drop_rate=drop,
        deterministic=False)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    y.backward(t(g).to(dtype))
    grads = [xt.grad.float().numpy()]
    for n, a in zip(NAMES, params):
        assert a.grad.dtype == torch.float32
        grads.append(_to_jax(n, a.grad.numpy()))
    return [a.detach().float().numpy() for a in (y, mean, var)], grads


@pytest.mark.parametrize("padding", ["same", "causal"])
@pytest.mark.parametrize("d,e,k,b,tt", SHAPES, ids=["d64k15", "d48e96k7"])
def test_plain_stages_match_pallas_fp32(d, e, k, b, tt, padding):
    """y, batch mean and variance, dx and all ten parameter gradients; the
    depthwise-bias gradient is exactly zero on both sides."""
    x, g, p = _inputs(1, d, e, k, b, tt)
    want_out, want_g = _jax_side(x, g, p, padding, 0, 0.0)
    got_out, got_g = _port_side(x, g, p, padding, 0, 0.0)
    for name, got, want in zip(("y", "mean", "var"), got_out, want_out):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5,
                                   err_msg=name)
    for name, got, want in zip(("x",) + NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    assert not np.abs(got_g[1 + NAMES.index("dw_b")]).any()
    assert not np.abs(want_g[1 + NAMES.index("dw_b")]).any()


@pytest.mark.parametrize("padding", ["same", "causal"])
def test_dropout_masks_and_gradients_match_pallas(padding):
    """Dropout 0.4: the outputs agree, the dropped entries are the same ones
    (entry by entry the port's hash mask with one tile per sequence), and
    the gradients agree."""
    d, e, k, b, tt = 48, 96, 7, 2, 33
    x, g, p = _inputs(2, d, e, k, b, tt)
    want_out, want_g = _jax_side(x, g, p, padding, 4321, 0.4)
    got_out, got_g = _port_side(x, g, p, padding, 4321, 0.4)
    for got, want in zip(got_out, want_out):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    for name, got, want in zip(("x",) + NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    mask = dropout_mask(4321, b * tt, e, 1, 0.6, tile_rows=tt).numpy()
    dropped = (mask == 0.0).reshape(b, tt, e)
    np.testing.assert_array_equal(want_out[0] == 0, dropped)
    np.testing.assert_array_equal(got_out[0] == 0, dropped)
    assert 0.3 < dropped.mean() < 0.5


@pytest.mark.parametrize(
    "drop,seed,padding,shape",
    [(0.0, 0, "same", (64, 64, 15, 2, 33)),
     (0.4, 77, "same", (64, 64, 15, 2, 33)),
     # d != E, causal, 111 rows: no multiple of the kernels' 64-row tiles,
     # which straddle the sequences of the flat (B T) layout
     (0.0, 0, "causal", (20, 24, 5, 3, 37)),
     (0.4, 77, "causal", (20, 24, 5, 3, 37))],
    ids=["nodrop", "drop0.4", "nodrop_causal_d20_e24", "drop0.4_causal_d20_e24"])
def test_plain_stages_match_pallas_bf16(drop, seed, padding, shape):
    """The plain stages, which the bf16 kernels are held against on the
    card, against the Pallas kernels in interpret mode (d, E, k, B, T)."""
    d, e, k, b, tt = shape
    x, g, p = _inputs(3, d, e, k, b, tt)
    want_out, want_g = _jax_side(x, g, p, padding, seed, drop, jnp.bfloat16)
    got_out, got_g = _port_side(x, g, p, padding, seed, drop, torch.bfloat16)
    names = ("y", "mean", "var", "x") + NAMES
    for name, got, want in zip(names, got_out + got_g, want_out + want_g):
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max(), name


def _module_pair(d, e, k, padding, x, seed=5, drop=0.0):
    jmod = JaxConvolutionModule(dim_model=d, dim_expand=e, drop_rate=drop,
                                kernel_size=k, padding=padding)
    params, stats = init_variables(jmod, jnp.asarray(x), seed=seed)
    port = ConvolutionModule(d, e, 1, k, padding, drop, fused_conv=True)
    port.load_state_dict(port_state(params, stats, wrap="conv_module",
                                    strip="conv_module."))
    return jmod, params, stats, port


@pytest.mark.parametrize("padding", ["same", "causal"])
def test_module_training_route_matches_jax_module(padding):
    """`ConvolutionModule(fused_conv=True).train()` against the JAX module
    under AVEC_TPU_FUSED_CONV=1 (its Pallas kernels in interpret mode), with
    parameters and running statistics carried over by `params_from_jax`:
    output and the updated running statistics."""
    d, e, k, b, tt = 32, 48, 7, 2, 21
    rng = np.random.RandomState(4)
    x = rng.randn(b, tt, d).astype(np.float32)
    jmod, params, stats, port = _module_pair(d, e, k, padding, x)
    os.environ["AVEC_TPU_FUSED_CONV"] = "1"
    try:
        want_y, mut = jmod.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), deterministic=False,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
    finally:
        del os.environ["AVEC_TPU_FUSED_CONV"]
    port.train()
    y = port(t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-5, rtol=1e-5)
    bn = port.layers["4"]
    want_bs = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want_bs["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want_bs["var"]), atol=1e-5)


@pytest.mark.parametrize("padding", ["same", "causal"])
def test_plain_backward_matches_autograd_of_unfused_module(padding):
    """In fp32 the fused route's plain forward and its written-out backward
    equal the port's unfused module differentiated by autograd (train-mode
    BatchNorm, detached depthwise bias), and so do the running statistics."""
    d, e, k, b, tt = 24, 40, 9, 3, 17
    rng = np.random.RandomState(8)
    x = rng.randn(b, tt, d).astype(np.float32)
    g = rng.randn(b, tt, e).astype(np.float32)
    _, _, _, fused = _module_pair(d, e, k, padding, x, seed=9)
    plain = ConvolutionModule(d, e, 1, k, padding, 0.0, fused_conv=False)
    plain.load_state_dict(fused.state_dict())
    outs = []
    for mod in (fused, plain):
        mod.train()
        xt = t(x).requires_grad_(True)
        y = mod(xt)
        y.backward(t(g))
        outs.append([y.detach(), xt.grad] + [
            p.grad for p in conv_module_params(mod)])
    for name, got, want in zip(("y", "x") + NAMES, *outs):
        if name == "dw_b":
            assert got is not None and not got.abs().any()
            assert want is None                   # detached in the layer
            continue
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4,
                                   rtol=5e-4, err_msg=name)
    for a, b_ in zip(fused.buffers(), plain.buffers()):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6)


def test_module_gate_and_eval_route():
    """Eval is bit-identical with the switch on and off; a stride-2 module
    and a 4-d input never take the fused route; the switch defaults to
    AVEC_TPU_FUSED_CONV; dropout draws its seed from `seed_generator` only
    when the rate is positive; `use_kernel=False` is the plain route on the
    CPU too."""
    d, e, k, b, tt = 16, 16, 5, 2, 14
    rng = np.random.RandomState(6)
    x = rng.randn(b, tt, d).astype(np.float32)
    _, _, _, fused = _module_pair(d, e, k, "same", x, drop=0.3)
    plain = ConvolutionModule(d, e, 1, k, "same", 0.3, fused_conv=False)
    plain.load_state_dict(fused.state_dict())
    assert torch.equal(fused(t(x)), plain(t(x)))
    assert fused.fused_eligible(3) and not fused.fused_eligible(4)
    assert not plain.fused_eligible(3)
    strided = ConvolutionModule(d, e, 2, k, "same", 0.0, fused_conv=True)
    assert not strided.fused_eligible(3)
    assert not ConvolutionModule(d, e, 1, k, "same-left", 0.0,
                                 fused_conv=True).fused_eligible(3)
    strided.train()
    before = strided.layers["4"].running_mean.clone()
    assert strided(t(x)).shape == (b, tt // 2, e)
    assert not torch.equal(strided.layers["4"].running_mean, before)
    os.environ["AVEC_TPU_FUSED_CONV"] = "1"
    try:
        assert ConvolutionModule(d, e).fused_conv
    finally:
        del os.environ["AVEC_TPU_FUSED_CONV"]
    assert not ConvolutionModule(d, e).fused_conv

    fused.train()
    fused.seed_generator = torch.Generator().manual_seed(3)
    state = fused.seed_generator.get_state()
    dropped = fused(t(x))
    assert 0.2 < float((dropped == 0).float().mean()) < 0.4
    assert not torch.equal(fused.seed_generator.get_state(), state)
    fused.regularize = False
    state = fused.seed_generator.get_state()
    clean = fused(t(x))
    assert torch.equal(fused.seed_generator.get_state(), state)
    fused.use_kernel = False
    assert torch.equal(fused(t(x)), clean)
