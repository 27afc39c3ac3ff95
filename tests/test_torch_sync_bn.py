"""The port's sync-BN on 4 gloo ranks on the CPU vs the JAX BatchNorm on the
global batch, as tests/test_sync_bn.py holds the JAX package's GSPMD sync-BN.

Each rank gets a slice of the global batch whose statistics differ from the
others' (so no rank's local statistics are the global ones) and runs the
port's layer with `process_group` set (`test_torch_parallel.batchnorm_rank`,
`conv_module_rank`). The outputs and input gradients are concatenated over
the ranks, the parameter gradients (each rank's partial sums) summed; the
running statistics must be the same on every rank.

Tolerances: y and running statistics 1e-5 (those of tests/test_sync_bn.py);
gradients 1e-4 of the largest entry (fp32 sums over 80-160 positions in
another order); the convolution module's output 1e-4 (tests/test_sync_bn.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models.conformer import ConvolutionModule as JaxConvolutionModule
from avec_tpu.ops.layers import BatchNorm as JaxBatchNorm
from avec_tpu_torch.parallel.dist import spawn

from test_torch_parallel import batchnorm_rank, conv_module_rank
from test_torch_support import init_variables, port_state

torch.set_num_threads(1)

WORLD = 4


def _per_rank_batch(shape, seed):
    """A channels-last global batch of WORLD slices, slice i scaled by i + 1
    and shifted by i."""
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(*shape) * (i + 1) + i
                           for i in range(WORLD)]).astype(np.float32)


def _channels_first(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


@pytest.mark.parametrize("shape", [(2, 5, 16), (2, 3, 4, 8)],
                         ids=["btc", "bhwc"])
def test_sync_batchnorm_matches_jax_on_the_global_batch(shape):
    x = _per_rank_batch(shape, 0)
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    bn = JaxBatchNorm()
    params, stats = init_variables(bn, jnp.asarray(x), seed=2,
                                   use_running_average=False)

    def fwd(p, x):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, x,
                          use_running_average=False, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    (want_y, want_bs), vjp = jax.vjp(fwd, params, jnp.asarray(x))
    want_gp, want_gx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like,
                                                          want_bs)))
    state = {"weight": params["scale"], "bias": params["bias"],
             "running_mean": stats["mean"], "running_var": stats["var"]}
    ranks = spawn(batchnorm_rank, WORLD, "gloo", "cpu", _channels_first(x),
                  _channels_first(g), state)
    y, gx = (np.concatenate([r[i] for r in ranks]) for i in (0, 1))
    np.testing.assert_allclose(np.moveaxis(y, 1, -1), np.asarray(want_y),
                               atol=1e-5)
    for got, want in ((np.moveaxis(gx, 1, -1), want_gx),
                      (sum(r[2] for r in ranks), want_gp["scale"]),
                      (sum(r[3] for r in ranks), want_gp["bias"])):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for i, key in ((4, "mean"), (5, "var")):
        for r in ranks:
            np.testing.assert_array_equal(r[i], ranks[0][i])
        np.testing.assert_allclose(ranks[0][i], np.asarray(want_bs[key]),
                                   atol=1e-5, err_msg=key)
    # the global statistics are none of the ranks' own
    local_var = [x[2 * i:2 * i + 2].reshape(-1, shape[-1]).var(0)
                 for i in range(WORLD)]
    assert all(np.abs(v - np.asarray(want_bs["var"])).max() > 0.05
               for v in local_var)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_module_statistics_match_the_global_batch(stride):
    """The convolution module in data-parallel training (fused_conv on: the
    K3dp plain stages at stride 1, the unfused layers with sync-BN at stride
    2) against the JAX module on the global batch: output and the updated
    running statistics."""
    x = np.stack([np.random.RandomState(i).randn(12, 16) * (1 + 0.5 * (i % 8))
                  for i in range(16)]).astype(np.float32)
    jmod = JaxConvolutionModule(dim_model=16, dim_expand=16, drop_rate=0.0,
                                stride=stride)
    params, stats = init_variables(jmod, jnp.asarray(x), seed=3)
    want_y, mut = jmod.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), deterministic=False,
                             mutable=["batch_stats"])
    state = {k: v.numpy() for k, v in port_state(
        params, stats, wrap="conv_module", strip="conv_module.").items()}
    ranks = spawn(conv_module_rank, WORLD, "gloo", "cpu", x, state,
                  (16, 16, stride, 15))
    y = np.concatenate([r[0] for r in ranks])
    np.testing.assert_allclose(y, np.asarray(want_y), atol=1e-4)
    want_bs = mut["batch_stats"]["BatchNorm_0"]
    for name, key in (("layers.4.running_mean", "mean"),
                      ("layers.4.running_var", "var")):
        for r in ranks:
            np.testing.assert_array_equal(r[1][name], ranks[0][1][name])
        np.testing.assert_allclose(ranks[0][1][name],
                                   np.asarray(want_bs[key]), atol=1e-5,
                                   err_msg=key)
        assert np.abs(ranks[0][1][name] - np.asarray(
            stats["BatchNorm_0"][key])).max() > 1e-3     # they moved
