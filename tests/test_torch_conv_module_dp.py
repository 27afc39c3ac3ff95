"""The port's data-parallel fused modules (the plain stages of K3dp, and the
DP forms of the fused FFN and attention module) on 2 and 4 gloo ranks on the
CPU vs the JAX DP wrappers on a 2- and 4-device sub-mesh of the 8-device CPU
test mesh, the Pallas kernels in interpret mode.

JAX side: `fused_conv_module_3d_dp`, `fused_ffn_3d_dp` and
`fused_attention_module_3d_dp` under `jax.shard_map` with the batch on the
'data' axis, gradients from `jax.vjp` (shard_map's transpose sums the
replicated parameters' cotangents over the shards). Port side: each rank runs
the port's `*_dp` function on its slice of the same global batch
(`test_torch_parallel.module_dp_rank`); y and dx are concatenated over the
ranks, the batch statistics are the same on every rank, and the parameter
gradients, each rank's partial sums, are summed over the ranks.

Tolerances: y, mean and var 3e-5, all eleven conv gradients 5e-4, absolute
and relative (those of tests/test_torch_conv_module.py); FFN 2e-5 / 3e-4 and
attention 3e-5 / 5e-4 as in their single-device tests. With dropout on, both
sides draw the hash mask from the rank's offset seed (seed + (rank + 1) *
0x68E31DA5 with int32 wraparound), so the dropped entries coincide, entry by
entry, with the port's mask for that seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from avec_tpu.ops.pallas_attention_module import (
    fused_attention_module_3d_dp as jax_att_dp)
from avec_tpu.ops.pallas_conv_module import (
    fused_conv_module_3d_dp as jax_conv_dp)
from avec_tpu.ops.pallas_ffn import fused_ffn_3d_dp as jax_ffn_dp
from avec_tpu_torch.ops.ffn import dropout_mask, shard_seed
from avec_tpu_torch.parallel.dist import spawn

import test_torch_attention_module as tatt
import test_torch_conv_module as tconv
import test_torch_ffn as tffn
from test_torch_parallel import module_dp_rank

torch.set_num_threads(1)

CONV_SHAPES = [(48, 48, 7, 21), (64, 64, 15, 17)]        # (d, E, k, T)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _jax_vjp(fn, x, g, params, n_outs):
    args = (jnp.asarray(x),) + tuple(jnp.asarray(p) for p in params)
    outs, vjp = jax.vjp(jax.jit(fn), *args)
    outs = outs if n_outs > 1 else (outs,)
    cots = (jnp.asarray(g),) + tuple(jnp.zeros_like(o) for o in outs[1:])
    grads = vjp(cots if n_outs > 1 else cots[0])
    return ([np.asarray(a) for a in outs], [np.asarray(a) for a in grads])


def _port(world, name, x, g, params, **kwargs):
    """(outputs, grads) of the port's DP form over `world` gloo ranks: y and
    dx concatenated, the other outputs from rank 0 (checked equal on every
    rank), the parameter gradients summed."""
    ranks = spawn(module_dp_rank, world, "gloo", "cpu", name, x, g, params,
                  kwargs)
    assert all(not r[2] for r in ranks)          # CPU: no kernel launched
    outs = [np.concatenate([r[0][0] for r in ranks])]
    for i in range(1, len(ranks[0][0])):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[0][i], ranks[0][0][i])
        outs.append(ranks[0][0][i])
    grads = [np.concatenate([r[1][0] for r in ranks])]
    grads += [sum(r[1][i] for r in ranks) for i in range(1, len(ranks[0][1]))]
    return outs, grads


def _dropped(seed, world, b, tt, ncols):
    """The positions each rank's hash mask drops (one tile per sequence),
    stacked over the ranks' shards: (b, tt, ncols)."""
    per = b // world
    return np.concatenate([
        dropout_mask(shard_seed(seed, r), per * tt, ncols, 1, 0.6,
                     tile_rows=tt).numpy().reshape(per, tt, ncols) == 0
        for r in range(world)])


@pytest.mark.parametrize("drop,seed", [(0.0, 0), (0.4, 4321)],
                         ids=["nodrop", "drop0.4"])
@pytest.mark.parametrize("padding", ["same", "causal"])
@pytest.mark.parametrize("d,e,k,tt", CONV_SHAPES, ids=["d48k7", "d64k15"])
@pytest.mark.parametrize("world", [2, 4])
def test_conv_module_dp_matches_jax_dp(world, d, e, k, tt, padding, drop,
                                       seed):
    """y, the global batch mean and variance, dx and all ten parameter
    gradients; the depthwise-bias gradient exactly zero on both sides; at
    dropout 0.4 the dropped entries of y are the rank's hash mask on both
    sides."""
    b = 4
    x, g, p = tconv._inputs(world + d, d, e, k, b, tt)

    def fn(x, *params):
        return jax_conv_dp(_mesh(world), "data", x, *params,
                           seed=jnp.asarray([seed], jnp.int32),
                           padding=padding, drop_rate=drop,
                           deterministic=False, interpret=True)

    want_out, want_g = _jax_vjp(fn, x, g, [p[n] for n in tconv.NAMES], 3)
    port_params = [tconv._to_port(n, p[n]) for n in tconv.NAMES]
    got_out, got_g = _port(world, "conv", x, g, port_params, seed=seed,
                           padding=padding, drop_rate=drop)
    got_g = got_g[:1] + [tconv._to_jax(n, a)
                         for n, a in zip(tconv.NAMES, got_g[1:])]
    for name, got, want in zip(("y", "mean", "var"), got_out, want_out):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5,
                                   err_msg=name)
    for name, got, want in zip(("x",) + tconv.NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    dwb = 1 + tconv.NAMES.index("dw_b")
    assert not np.abs(got_g[dwb]).any() and not np.abs(want_g[dwb]).any()
    if drop:
        dropped = _dropped(seed, world, b, tt, e)
        np.testing.assert_array_equal(want_out[0] == 0, dropped)
        np.testing.assert_array_equal(got_out[0] == 0, dropped)
        assert 0.3 < dropped.mean() < 0.5


@pytest.mark.parametrize("world", [2, 4])
def test_ffn_dp_matches_jax_dp_at_dropout(world):
    """Forward, dx and the six parameter gradients at dropout 0.4: the rank
    seed offsets agree, so the masks and the gradients do."""
    x, g, p = tffn._inputs(5, 4, 23, 40, 96)

    def fn(x, *params):
        return jax_ffn_dp(_mesh(world), "data", x, *params, seed=777,
                          drop_rate=0.4, deterministic=False, interpret=True)

    want_out, want_g = _jax_vjp(fn, x, g, [p[n] for n in tffn.NAMES], 1)
    port_params = [p["scale"], p["bias"], p["w1"].T.copy(), p["b1"],
                   p["w2"].T.copy(), p["b2"]]
    got_out, got_g = _port(world, "ffn", x, g, port_params, seed=777,
                           drop_rate=0.4)
    got_g[3], got_g[5] = got_g[3].T, got_g[5].T        # back to (d, F), (F, d)
    np.testing.assert_allclose(got_out[0], want_out[0], atol=2e-5, rtol=2e-5)
    for name, got, want in zip(("x",) + tffn.NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(got_out[0] == 0, want_out[0] == 0)
    assert 0.3 < float((got_out[0] == 0).mean()) < 0.5


@pytest.mark.parametrize("world", [2, 4])
def test_attention_module_dp_matches_jax_dp_at_dropout(world):
    """Output, dx and the twelve parameter gradients at dropout 0.4 with
    ragged lengths sharded beside the batch; the dropped entries are the
    rank's hash mask on both sides."""
    b, tt, d, heads = 4, 19, 32, 2
    x, g, p = tatt._inputs(6, b, tt, d)
    lengths = np.array([tt, 11, 16, 7], np.int32)

    def fn(x, *params):
        return jax_att_dp(_mesh(world), "data", x, *params, num_heads=heads,
                          lengths=jnp.asarray(lengths),
                          seed=jnp.asarray([99], jnp.int32), drop_rate=0.4,
                          deterministic=False, residual=False,
                          interpret=True)

    want_out, want_g = _jax_vjp(fn, x, g, [p[n] for n in tatt.NAMES], 1)
    port_params = [p[n].T.copy() if n in tatt.MATRICES else p[n]
                   for n in tatt.NAMES]
    got_out, got_g = _port(world, "att", x, g, port_params, num_heads=heads,
                           lengths=lengths, seed=99, drop_rate=0.4,
                           residual=False)
    got_g = got_g[:1] + [a.T if n in tatt.MATRICES else a
                         for n, a in zip(tatt.NAMES, got_g[1:])]
    np.testing.assert_allclose(got_out[0], want_out[0], atol=3e-5, rtol=3e-5)
    for name, got, want in zip(("x",) + tatt.NAMES, got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    dropped = _dropped(99, world, b, tt, d)
    np.testing.assert_array_equal(want_out[0] == 0, dropped)
    np.testing.assert_array_equal(got_out[0] == 0, dropped)
