"""The port's train-mode video stem (`fused_stem_train`, the K5 path in
training) vs the JAX package, fp32 on the CPU.

The JAX side is `avec_tpu.ops.pallas_stem.fused_stem_train(...,
interpret=True)` on the polyphase-folded inputs that the JAX encoder builds
(`FusedVideoStem._pallas_path`: T padded to a multiple of 4, `t_valid` the
true T); its gradients come from `jax.vjp` through the custom VJP and the
(linear) fold. The port takes the unfolded video and the conv kernel in the
torch layout and pads nothing. B=2, T=6, 88 x 88 zero-mean frames (a large
mean over a small variance would amplify the two convs' fp32 rounding
through the normalisation).

Tolerances: pooled, mean, var 1e-5; gradients of the conv weight, BN scale
and BN bias 1e-4 of the largest entry; the conv-bias gradient is exactly zero
on both sides. The module in mode "pallas" is also held against the port's
own "2d" training route (outputs 1e-5, gradients 1e-4 of the largest entry,
running statistics 1e-6) and against the JAX module's running-statistics
update (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avec_tpu.models.encoders import FusedVideoStem as JaxStem
from avec_tpu.ops import pallas_stem as jstem
from avec_tpu.ops.layers import _polyphase_fold
from avec_tpu.ops.layers import conv_padding as jax_conv_padding
from avec_tpu_torch.models.encoders import FusedVideoStem
from avec_tpu_torch.ops.stem import fused_stem_train

from test_torch_support import init_variables, port_state, t

torch.set_num_threads(1)

B, T = 2, 6


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, 88, 88, 1) * 0.5).astype(np.float32)
    kernel = rng.uniform(-245 ** -0.5, 245 ** -0.5,
                         size=(5, 7, 7, 1, 64)).astype(np.float32)
    bias = rng.uniform(-245 ** -0.5, 245 ** -0.5, size=64).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    bn_bias = (0.1 * rng.randn(64)).astype(np.float32)
    cot = rng.randn(B, T, 22, 22, 64).astype(np.float32)
    return x, kernel, bias, scale, bn_bias, cot


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_fused_stem_train_matches_pallas_interpret():
    x, kernel, bias, scale, bn_bias, cot = _inputs()
    ks, strides = (5, 7, 7), (1, 2, 2)
    tp = -(-T // 4) * 4

    def fn(kernel, bias, scale, bn_bias):
        xp, kp, _ = _polyphase_fold(jnp.asarray(x), kernel, ks, strides,
                                    jax_conv_padding(ks, "same"))
        xp = jnp.pad(xp, ((0, 0), (0, tp - T), (0, 0), (0, 0), (0, 0)))
        pooled, mean, var = jstem.fused_stem_train(
            xp, kp.reshape(-1, 64), bias, scale, bn_bias, T, 1e-5, True)
        return pooled[:, :T], mean, var

    (want_p, want_m, want_v), vjp = jax.vjp(
        fn, *(jnp.asarray(a) for a in (kernel, bias, scale, bn_bias)))
    want_g = vjp((jnp.asarray(cot), jnp.zeros(64), jnp.zeros(64)))

    leaves = [t(np.transpose(kernel, (4, 3, 0, 1, 2)).copy()), t(bias),
              t(scale), t(bn_bias)]
    for a in leaves:
        a.requires_grad_(True)
    pooled, mean, var = fused_stem_train(t(x), *leaves, 1e-5)
    assert pooled.shape == (B * T, 22, 22, 64)
    assert not mean.requires_grad and not var.requires_grad
    pooled.backward(t(cot).reshape(B * T, 22, 22, 64))
    np.testing.assert_allclose(pooled.detach().numpy().reshape(want_p.shape),
                               np.asarray(want_p), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_m), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-5)
    got_w = np.transpose(leaves[0].grad.numpy(), (2, 3, 4, 1, 0))
    assert _rel(got_w, np.asarray(want_g[0])) <= 1e-4
    assert _rel(leaves[2].grad.numpy(), np.asarray(want_g[2])) <= 1e-4
    assert _rel(leaves[3].grad.numpy(), np.asarray(want_g[3])) <= 1e-4
    assert np.abs(np.asarray(want_g[1])).max() == 0.0
    assert float(leaves[1].grad.abs().max()) == 0.0


def test_pallas_stem_trains_like_the_2d_route_and_the_jax_module():
    """`FusedVideoStem("pallas").train()` against the port's "2d" training
    route (outputs, gradients, running statistics) and against the JAX
    module's updated running statistics (unbiased variance over B T 44 44
    positions, flax momentum 0.9)."""
    x, _, _, _, _, cot = _inputs(1)
    jmod = JaxStem(use_pallas=True, interpret=True)
    params, stats = init_variables(jmod, x, deterministic=True, seed=3)
    want_y, mutated = jmod.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), deterministic=False,
                                 mutable=["batch_stats"])
    state = port_state(params, stats, wrap="front_end_stem",
                       strip="front_end.0.")
    results = {}
    for mode in ("pallas", "2d"):
        stem = FusedVideoStem(mode)
        stem.load_state_dict(state)
        stem.train()
        y = stem(t(x))
        (y * t(cot).reshape(y.shape)).sum().backward()
        results[mode] = (y.detach().numpy(), stem)
    (y_p, stem_p), (y_2, stem_2) = results["pallas"], results["2d"]
    np.testing.assert_allclose(y_p, np.asarray(want_y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_p, y_2, rtol=0, atol=1e-5)
    conv_p, bn_p = stem_p.layers[0]
    conv_2, bn_2 = stem_2.layers[0]
    assert float(conv_p.bias.grad.abs().max()) == 0.0
    assert conv_2.bias.grad is None                 # detached on that route
    for got, want in ((conv_p.weight.grad, conv_2.weight.grad),
                      (bn_p.weight.grad, bn_2.weight.grad),
                      (bn_p.bias.grad, bn_2.bias.grad)):
        assert _rel(got.numpy(), want.numpy()) <= 1e-4
    bs = mutated["batch_stats"]["BatchNorm_0"]
    for name, want in (("running_mean", bs["mean"]),
                       ("running_var", bs["var"])):
        got = getattr(bn_p, name).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, getattr(bn_2, name).numpy(), rtol=0,
                                   atol=1e-6)
        assert np.abs(got - np.asarray(stats["BatchNorm_0"][
            "mean" if name == "running_mean" else "var"])).max() > 1e-3
    stem_p.eval()                                   # eval takes the new stats
    assert stem_p(t(x)).shape == (B * T, 22, 22, 64)
