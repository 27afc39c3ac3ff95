"""Port attention vs the JAX package, fp32 on the CPU.

The flash kernel's (K4) plain version is held against the Pallas kernel in
interpret mode, to 1e-4 as tests/test_pallas_attention.py uses; attention
modules to 1e-4. The CUDA kernel itself is held against the plain version
in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avec_tpu.ops import attention as ja
from avec_tpu.ops.masks import padding_mask as jax_padding_mask
from avec_tpu.ops.pallas_attention import flash_attention as jax_flash
from avec_tpu.ops.pallas_attention import rel_pos_flash_attention as jax_rel_flash
from avec_tpu_torch.ops import attention as pa
from avec_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                rel_pos_flash_attention)
from avec_tpu_torch.ops.masks import padding_mask

from test_torch_support import init_variables, port_state, t

TOL = 1e-4
torch.set_num_threads(1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               np.asarray(want), rtol=0, atol=tol)


def _qkv(seed, b=2, h=2, t_=40, da=37, dv=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t_, da).astype(np.float32),
            rng.randn(b, h, t_, da).astype(np.float32),
            rng.randn(b, h, t_, dv).astype(np.float32))


def test_plain_flash_matches_pallas_interpret():
    """Odd widths and T not a multiple of the block; one row of length 1."""
    q, k, v = _qkv(0)
    lengths = np.array([40, 1], np.int32)
    want = jax_flash(q, k, v, lengths=jnp.asarray(lengths), scale=0.3,
                     block_q=16, block_k=16, interpret=True)
    got, lse = flash_attention_reference(t(q), t(k), t(v), t(lengths), 0.3)
    _close(got, want)
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    scores = np.where(np.arange(40)[None, None, None] < lengths[:, None, None,
                                                                  None],
                      scores, -1e30)
    m = scores.max(-1, keepdims=True)
    want_lse = (m[..., 0] + np.log(np.exp(scores - m).sum(-1))).reshape(4, 40)
    _close(lse, want_lse)


def test_plain_rel_pos_flash_matches_pallas_interpret():
    d_model, h, t_ = 32, 4, 24
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, h, t_, d_model // h).astype(np.float32)
               for _ in range(3))
    pos_kernel = (rng.randn(d_model, d_model) * 0.2).astype(np.float32)
    pos_bias = (rng.randn(d_model) * 0.2).astype(np.float32)
    lengths = np.array([24, 13], np.int32)
    want = jax_rel_flash(q, k, v, pos_kernel, pos_bias, d_model, h,
                         lengths=jnp.asarray(lengths), interpret=True)
    got = rel_pos_flash_attention(t(q), t(k), t(v), t(pos_kernel),
                                  t(pos_bias), d_model, h, lengths=t(lengths))
    _close(got, want)


def _jax_and_port(cls_jax, cls_port, x, mask, jkw, pkw):
    mod = cls_jax(**jkw)
    params, _ = init_variables(mod, x, mask, seed=2)
    port = cls_port(**pkw)
    port.load_state_dict(port_state(params))
    return mod, params, port


@pytest.mark.parametrize("t_", [12, 14])
@pytest.mark.parametrize("kind", ["mha", "relpos", "patch"])
def test_attention_modules_match(kind, t_):
    d_model, h = 16, 4
    rng = np.random.RandomState(3)
    x = rng.randn(2, t_, d_model).astype(np.float32)
    lengths = np.array([t_, 7], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), t_)
    jcls, pcls = {"mha": (ja.MultiHeadAttention, pa.MultiHeadAttention),
                  "relpos": (ja.RelPos1dMultiHeadAttention,
                             pa.RelPos1dMultiHeadAttention),
                  "patch": (ja.RelPosPatch1dMultiHeadAttention,
                            pa.RelPosPatch1dMultiHeadAttention)}[kind]
    mod, params, port = _jax_and_port(
        jcls, pcls, x, mask, dict(dim_model=d_model, num_heads=h),
        dict(dim_model=d_model, num_heads=h))
    want = mod.apply({"params": params}, x, mask)
    _close(port(t(x), padding_mask(t(lengths), t_)), want)


def test_flash_module_matches_factorized_module():
    """Port RelPos1d with use_flash (plain flash on the CPU) == the JAX
    module on its default factorized path, every row (key-only masks)."""
    d_model, h, t_ = 32, 4, 30
    rng = np.random.RandomState(4)
    x = rng.randn(2, t_, d_model).astype(np.float32)
    lengths = np.array([30, 1], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), t_)
    mod, params, port = _jax_and_port(
        ja.RelPos1dMultiHeadAttention, pa.RelPos1dMultiHeadAttention, x, mask,
        dict(dim_model=d_model, num_heads=h, use_flash=False),
        dict(dim_model=d_model, num_heads=h, use_flash=True))
    want = mod.apply({"params": params}, x, mask)
    pmask = padding_mask(t(lengths), t_)
    _close(port(t(x), pmask), want)
    _close(port(t(x), pmask, lengths=t(lengths)), want)


def test_flash_full_mask_falls_back():
    """A full (B, 1, T, T) mask cannot be expressed as key lengths: the
    flash module must run the exact factorized path instead."""
    d_model, h, t_ = 32, 4, 20
    rng = np.random.RandomState(5)
    x = rng.randn(2, t_, d_model).astype(np.float32)
    lengths = np.array([20, 12], np.int32)
    band = np.abs(np.arange(t_)[:, None] - np.arange(t_)[None]) <= 4
    full = band[None, None] & np.asarray(jax_padding_mask(jnp.asarray(lengths),
                                                          t_))
    mod, params, port = _jax_and_port(
        ja.RelPos1dMultiHeadAttention, pa.RelPos1dMultiHeadAttention, x, full,
        dict(dim_model=d_model, num_heads=h),
        dict(dim_model=d_model, num_heads=h, use_flash=True))
    want = mod.apply({"params": params}, x, jnp.asarray(full))
    _close(port(t(x), t(full)), want)
