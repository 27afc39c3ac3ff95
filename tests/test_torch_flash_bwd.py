"""The port's flash backward (plain version of K4b) vs the JAX Pallas kernels.

The JAX side is `jax.grad` of `flash_attention_trainable(..., interpret=True)`
and of `rel_pos_flash_attention(..., interpret=True)`: the custom VJP, i.e.
the Pallas dq and dk/dv kernels, as the JAX package's own tests run them on
the CPU. The port side is `flash_attention` / `rel_pos_flash_attention` on
CPU tensors: the plain forward and `flash_attention_bwd_reference`. fp32,
numpy inputs from a seed, ragged lengths including 1. Tolerance 1e-4
absolute on every gradient (sums over at most 40 keys). At the flash
route's own widths (d_a = 321 / 451, d_v = 64 / 90; T = 151 above the JAX
kernels' 128-row block, and 76): fp32 at 1e-4 absolute, and bf16 inputs at
8e-3 of each gradient's largest entry (both sides compute in fp32 and round
each gradient to bf16 once: one bf16 step is 2^-8 of an entry, and the
forwards' bf16 outputs, which delta reads, may differ by one step).
"""

import pytest

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avec_tpu.ops.pallas_attention import (flash_attention_trainable,
                                           rel_pos_flash_attention as jax_rel)
from avec_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_reference,
                                                rel_pos_flash_attention)

from test_torch_support import t

torch.set_num_threads(1)
TOL = 1e-4
BF16_TOL = 8e-3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _qkvg(seed, b=3, h=2, tt=40, da=37, dv=12):
    rng = np.random.RandomState(seed)
    mk = lambda d, s: (rng.randn(b, h, tt, d) * s).astype(np.float32)
    return mk(da, 0.4), mk(da, 0.4), mk(dv, 1.0), mk(dv, 1.0)


def test_plain_flash_backward_matches_pallas_interpret():
    q, k, v, g = _qkvg(0)
    lengths = np.array([40, 17, 1], np.int32)

    def loss(q, k, v):
        out = flash_attention_trainable(q, k, v, jnp.asarray(lengths), 0.3,
                                        True)
        return (out * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, t(lengths), 0.3)
    out.backward(t(g))
    for got, w in zip(leaves, want):
        _close(got.grad, w)
    # queries and keys at or past the length get an exactly zero gradient
    pad = t(np.arange(40)[None, :] >= lengths[:, None])[:, None, :, None]
    for got in leaves:
        assert float((got.grad * pad).abs().max()) == 0.0


def test_plain_rel_pos_flash_gradients_match_pallas_interpret():
    """Through `rel_pos_augment` too (plain on both sides): gradients of
    q, k, v and of the positional kernel and bias."""
    d_model, h, tt = 32, 4, 24
    rng = np.random.RandomState(1)
    q, k, v, g = ((rng.randn(2, h, tt, d_model // h) * 0.5).astype(np.float32)
                  for _ in range(4))
    pos_k = (rng.randn(d_model, d_model) / np.sqrt(d_model)).astype(np.float32)
    pos_b = (rng.randn(d_model) * 0.1).astype(np.float32)
    lengths = np.array([24, 9], np.int32)

    def loss(q, k, v, pk, pb):
        out = jax_rel(q, k, v, pk, pb, d_model, h,
                      lengths=jnp.asarray(lengths), interpret=True)
        return (out * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, pos_k, pos_b)))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v, pos_k, pos_b)]
    out = rel_pos_flash_attention(*leaves, d_model, h, lengths=t(lengths))
    out.backward(t(g))
    for got, w in zip(leaves, want):
        _close(got.grad, w)


def test_length_zero_gives_finite_zero_gradients():
    """A sequence without a valid key softmaxes uniformly in the forward;
    its gradients are all zero, not NaN."""
    q, k, v, g = _qkvg(2, b=2, tt=19, da=13, dv=6)
    lengths = t(np.array([0, 19], np.int32))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, lengths, 0.5)
    assert bool(torch.isfinite(out).all())
    out.backward(t(g))
    for a in leaves:
        assert bool(torch.isfinite(a.grad).all())
        assert float(a.grad[0].abs().max()) == 0.0
        assert float(a.grad[1].abs().max()) > 0.0


def test_backward_wrapper_from_saved_lse():
    """`flash_attention_bwd` from q', k', v, dO, lse, delta equals autograd
    through the plain forward on the rows inside the length."""
    q, k, v, g = _qkvg(3, b=2, tt=21, da=10, dv=5)
    lengths = t(np.array([21, 8], np.int32))
    qt, kt, vt, gt = (t(a) for a in (q, k, v, g))
    out, lse = flash_attention_reference(qt, kt, vt, lengths, 0.7)
    delta = (gt * out).sum(-1).reshape(lse.shape)
    got = flash_attention_bwd(qt, kt, vt, gt, lse, delta, lengths, 0.7)
    leaves = [a.clone().requires_grad_(True) for a in (qt, kt, vt)]
    ref, _ = flash_attention_reference(*leaves, lengths, 0.7)
    row_ok = (torch.arange(21)[None, :] < lengths[:, None])[:, None, :, None]
    (ref * gt * row_ok).sum().backward()
    for a, b in zip(got, leaves):
        _close(a, b.grad.numpy(), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tt,da,dv,lengths", [
    (151, 321, 64, [151, 0]),    # audio stage 2 of the train step
    (76, 451, 90, [76, 1]),      # audio stage 3
])
def test_plain_flash_backward_matches_pallas_at_route_widths(tt, da, dv,
                                                             lengths, dtype):
    """The plain K4b against the JAX Pallas dq and dk/dv kernels (interpret
    mode) at the widths and lengths the flash route gives them, (B, H) =
    (2, 2): the same bf16 values on both sides where the inputs are bf16."""
    rng = np.random.RandomState(tt)
    mk = lambda d, s: (rng.randn(2, 2, tt, d) * s).astype(np.float32)
    q, k, v, g = mk(da, 0.3), mk(da, 0.3), mk(dv, 1.0), mk(dv, 1.0)
    scale = 1.0 / np.sqrt(da)
    lens = np.array(lengths, np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    _, vjp = jax.vjp(
        lambda q, k, v: flash_attention_trainable(q, k, v, jnp.asarray(lens),
                                                  scale, True),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g).astype(jdt))
    leaves = [t(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    flash_attention(*leaves, t(lens), scale).backward(t(g).to(tdt))
    for got, w in zip(leaves, want):
        assert got.grad.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        got = got.grad.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, w, rtol=0, atol=TOL)
        else:
            assert np.abs(got - w).max() <= BF16_TOL * np.abs(w).max()
    # queries and keys at or past the length: exact zeros on the port's side
    pad = t(np.arange(tt)[None, :] >= lens[:, None])[:, None, :, None]
    for a in leaves:
        assert float((a.grad.float() * pad).abs().max()) == 0.0
