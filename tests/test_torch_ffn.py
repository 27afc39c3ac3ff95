"""The port's fused FFN (plain version of K1/K1b) vs the JAX Pallas kernels.

The JAX side is `avec_tpu.ops.pallas_ffn.fused_ffn_3d(..., interpret=True)`,
as the JAX package's own tests run it on the CPU; its gradients come from
`jax.grad` through the custom VJP, i.e. from the Pallas backward kernel. The
port side is `fused_ffn_3d` on CPU tensors (the plain version, differentiated
by autograd). Inputs and parameters are numpy draws from a seed. The port
keeps the Linear (out, in) weight layout, so W1 and W2 are transposed on the
way in and their gradients on the way back.

Tolerances: fp32 forward 2e-5, gradients 3e-4 (both absolute and relative,
sums over up to 600 rows in another order); bf16 3e-2 of the largest entry.
With dropout on, both sides draw the same hash masks from the same seed, so
the same tolerances hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.ops.pallas_ffn import fused_ffn_3d as jax_fused_ffn_3d
from avec_tpu_torch.ops.ffn import dropout_mask, fused_ffn_3d

from test_torch_support import t

torch.set_num_threads(1)

NAMES = ("scale", "bias", "w1", "b1", "w2", "b2")


def _inputs(seed, b, tt, d, f):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, tt, d).astype(np.float32)
    g = rng.randn(b, tt, d).astype(np.float32)
    u = lambda shape, s: rng.uniform(-s, s, size=shape).astype(np.float32)
    p = dict(scale=(1.0 + 0.1 * rng.randn(d)).astype(np.float32),
             bias=(0.1 * rng.randn(d)).astype(np.float32),
             w1=u((d, f), d ** -0.5), b1=u((f,), d ** -0.5),
             w2=u((f, d), f ** -0.5), b2=u((d,), f ** -0.5))
    return x, g, p


def _jax_side(x, g, p, seed, drop, dtype=jnp.float32):
    def fn(x, *params):
        return jax_fused_ffn_3d(x, *params, seed=seed, drop_rate=drop,
                                deterministic=False, interpret=True)

    args = (jnp.asarray(x, dtype),) + tuple(jnp.asarray(p[n]) for n in NAMES)
    y, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g, dtype))
    return (np.asarray(y, np.float32),
            [np.asarray(a, np.float32) for a in grads])


def _port_side(x, g, p, seed, drop, dtype=torch.float32):
    xt = t(x).to(dtype).requires_grad_(True)
    params = [t(p["scale"]), t(p["bias"]), t(p["w1"].T.copy()), t(p["b1"]),
              t(p["w2"].T.copy()), t(p["b2"])]
    for a in params:
        a.requires_grad_(True)
    y = fused_ffn_3d(xt, *params, seed=seed, drop_rate=drop,
                     deterministic=False)
    y.backward(t(g).to(dtype))
    grads = [a.grad.float().numpy() for a in [xt] + params]
    grads[3], grads[5] = grads[3].T, grads[5].T      # back to (d, F), (F, d)
    return y.detach().float().numpy(), grads


@pytest.mark.parametrize("drop,seed", [(0.0, 0), (0.3, 12345)],
                         ids=["nodrop", "drop0.3"])
@pytest.mark.parametrize("b,tt,d,f", [(2, 37, 180, 720), (3, 201, 45, 100)],
                         ids=["d180", "d45_three_tiles"])
def test_plain_ffn_matches_pallas_fp32(b, tt, d, f, drop, seed):
    """Forward, dx and all six parameter gradients; 3 x 201 = 603 rows span
    three 256-row hash tiles and are no multiple of 256."""
    x, g, p = _inputs(1, b, tt, d, f)
    want_y, want_g = _jax_side(x, g, p, seed, drop)
    got_y, got_g = _port_side(x, g, p, seed, drop)
    np.testing.assert_allclose(got_y, want_y, atol=2e-5, rtol=2e-5)
    for name, got, want in zip(("x",) + NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4,
                                   err_msg=name)
    if drop:
        # dropped outputs are exactly zero on both sides, in the same places
        np.testing.assert_array_equal(got_y == 0.0, want_y == 0.0)
        assert 0.2 < float((got_y == 0.0).mean()) < 0.4


@pytest.mark.parametrize(
    "drop,seed,shape",
    [(0.0, 0, (2, 150, 52, 208)), (0.3, 7, (2, 150, 52, 208)),
     # 3 x 37 = 111 rows: one full and one ragged 64-row tile, d = 20 under
     # one 64-column tile, F = 70 past one 64-column hidden chunk
     (0.0, 0, (3, 37, 20, 70)), (0.3, 7, (3, 37, 20, 70))],
    ids=["nodrop", "drop0.3", "nodrop_rows111_d20", "drop0.3_rows111_d20"])
def test_plain_ffn_matches_pallas_bf16(drop, seed, shape):
    """The plain version, which the bf16 kernels are held against on the
    card, against the Pallas kernel in interpret mode at (B, T, d, F)."""
    x, g, p = _inputs(2, *shape)
    want_y, want_g = _jax_side(x, g, p, seed, drop, jnp.bfloat16)
    got_y, got_g = _port_side(x, g, p, seed, drop, torch.bfloat16)
    for name, got, want in zip(("y", "x") + NAMES, [got_y] + got_g,
                               [want_y] + want_g):
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max(), name


def test_dropout_masks_equal_the_interpret_mode_kernel():
    """With unit weights the JAX kernel's output exposes its outer mask:
    identical to the port's hash mask, entry by entry."""
    d, f, n = 8, 16, 300
    rng = np.random.RandomState(0)
    x = rng.randn(1, n, d).astype(np.float32)
    p = dict(scale=np.ones(d, np.float32), bias=np.zeros(d, np.float32),
             w1=np.zeros((d, f), np.float32), b1=np.zeros(f, np.float32),
             w2=np.zeros((f, d), np.float32), b2=np.ones(d, np.float32))
    y, _ = _jax_side(x, np.zeros_like(x), p, 99, 0.25)
    want = dropout_mask(99, n, d, 2, 0.75).numpy()
    np.testing.assert_array_equal(y[0], want)


def test_eval_and_training_gate_of_the_module():
    """The module takes the fused path only in training mode on a 3-d input
    (conformer.py:103-107); eval runs the unfused layers, and with dropout
    off both compute the same function."""
    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops.layers import init_params

    mod = init_params(FeedForwardModule(20, 80, drop_rate=0.1),
                      torch.Generator().manual_seed(0))
    mod.seed_generator = torch.Generator().manual_seed(1)
    x = torch.randn(2, 11, 20, generator=torch.Generator().manual_seed(2))
    mod.eval()
    want = mod(x)
    mod.train()
    dropped = mod(x)
    assert float((dropped == 0).float().mean()) > 0.03
    for m in mod.modules():                           # dropout off
        m.regularize = False
    np.testing.assert_allclose(mod(x).detach().numpy(), want.detach().numpy(),
                               atol=2e-6)
    flat = mod(x.reshape(22, 20))                     # 2-d: unfused layers
    np.testing.assert_allclose(flat.detach().numpy(),
                               want.reshape(22, 20).detach().numpy(),
                               atol=2e-6)
