"""Port ops vs the JAX package: masks, activations, layers, fbank, CTC collapse.

Same seeded numpy inputs through both, fp32 on the CPU. Tolerance: max abs
1e-4 unless stated (masks, pools and the CTC collapse are exact).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avec_tpu.ops import activations as jact
from avec_tpu.ops import layers as jl
from avec_tpu.ops import masks as jm
from avec_tpu.ops.audio import AudioPreprocessing as JaxFbank
from avec_tpu.ops.ctc import ctc_greedy_collapse as jax_collapse
from avec_tpu_torch.ops import activations as pact
from avec_tpu_torch.ops import layers as pl
from avec_tpu_torch.ops import masks as pm
from avec_tpu_torch.ops.audio import AudioPreprocessing
from avec_tpu_torch.ops.ctc import ctc_greedy_collapse

from test_torch_support import init_variables, t

TOL = 1e-4
torch.set_num_threads(1)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_masks_match():
    lengths = np.array([7, 3, 10], np.int32)
    _close(pm.padding_mask(t(lengths), 10), jm.padding_mask(lengths, 10), 0)
    for lc, rc in ((None, None), (2, 0), (3, 1)):
        want = jm.make_mask(10, jnp.asarray(lengths), lc, rc)
        _close(pm.make_mask(10, t(lengths), lc, rc), want, 0)
        _close(pm.downsample_mask(pm.make_mask(10, t(lengths), lc, rc), 2),
               jm.downsample_mask(want, 2), 0)
    _close(pm.strided_lengths(t(lengths), 2),
           jm.strided_lengths(jnp.asarray(lengths), 2), 0)
    full = pm.make_mask(9, t(np.array([9, 4])), 3, 3)
    _close(pm.min_pool_mask(full, 3),
           jm.min_pool_mask(jnp.asarray(full.numpy()), 3), 0)
    pad = pm.padding_mask(t(np.array([9, 4])), 9)
    _close(pm.min_pool_mask(pad, 3),
           jm.min_pool_mask(jnp.asarray(pad.numpy()), 3), 0)


def test_activations_match():
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    _close(pact.swish(t(x)), jact.swish(x))
    _close(pact.glu(t(x)), jact.glu(x))


def test_linear_matches():
    x = np.random.RandomState(1).randn(2, 5, 12).astype(np.float32)
    mod = jl.Linear(7)
    params, _ = init_variables(mod, x)
    want = mod.apply({"params": params}, x)
    lin = pl.Linear(12, 7)
    lin.load_state_dict({"weight": t(params["kernel"].T),
                         "bias": t(params["bias"])})
    _close(lin(t(x)), want)


CONV_CASES = [  # ndim, kernel, stride, padding, groups
    (1, 15, 1, "same", 8),
    (1, 15, 2, "same", 8),
    (1, 4, 1, "causal", 1),
    (1, 1, 2, "valid", 1),
    (2, 3, 2, "same", 1),
    (2, 4, 1, "same", 1),
    (3, (5, 7, 7), (1, 2, 2), "same", 1),
]


@pytest.mark.parametrize("ndim,k,s,padding,groups", CONV_CASES)
def test_conv_matches(ndim, k, s, padding, groups):
    spatial = {1: (21,), 2: (11, 9), 3: (4, 14, 14)}[ndim]
    cin = 8 if groups > 1 else (1 if ndim == 3 else 4)
    x = np.random.RandomState(2).randn(2, *spatial, cin).astype(np.float32)
    mod = jl.Conv(8, k, ndim=ndim, strides=s, padding=padding, groups=groups)
    params, _ = init_variables(mod, x, seed=3)
    want = mod.apply({"params": params}, x)
    conv = pl.Conv(cin, 8, k, ndim=ndim, stride=s, padding=padding,
                   groups=groups)
    kern = params["kernel"]
    conv.load_state_dict({
        "weight": t(kern.transpose((ndim + 1, ndim) + tuple(range(ndim)))),
        "bias": t(params["bias"])})
    got = conv(t(x).movedim(-1, 1)).movedim(1, -1)
    _close(got, want)


@pytest.mark.parametrize("ks,st,padding,shape", [
    ((1,), (2,), "valid", (2, 9, 4)),
    ((3, 3), (2, 2), "same", (2, 44, 44, 3)),
    ((3,), (3,), "valid", (2, 12, 5)),
])
def test_pools_match(ks, st, padding, shape):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    _close(pl.max_pool(t(x), ks, st, padding), jl.max_pool(x, ks, st, padding),
           0)
    _close(pl.avg_pool(t(x), ks, st, padding), jl.avg_pool(x, ks, st, padding))
    _close(pl.upsample_nearest(t(x), 3), jl.upsample_nearest(x, 3), 0)


def test_norms_match():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 10).astype(np.float32) * 3 + 1
    ln = jl.LayerNorm(epsilon=1e-6)
    params, _ = init_variables(ln, x, seed=6)
    pln = pl.LayerNorm(10, eps=1e-6)
    pln.load_state_dict({"weight": t(params["scale"]), "bias": t(params["bias"])})
    _close(pln(t(x)), ln.apply({"params": params}, x))

    bn = jl.BatchNorm()
    params, stats = init_variables(bn, x, use_running_average=True, seed=7)
    want = bn.apply({"params": params, "batch_stats": stats}, x,
                    use_running_average=True)
    pbn = pl.BatchNorm(10)
    pbn.load_state_dict({"weight": t(params["scale"]), "bias": t(params["bias"]),
                         "running_mean": t(stats["mean"]),
                         "running_var": t(stats["var"])})
    _close(pbn(t(x).transpose(1, 2)).transpose(1, 2), want)


def test_fbank_matches():
    """80 log-mels, no normalisation (the encoder's setting)."""
    rng = np.random.RandomState(8)
    x = (rng.randn(2, 8000) * 0.1).astype(np.float32)
    lengths = np.array([8000, 5000], np.int32)
    want, wlen = JaxFbank(normalize=False)(x, lengths)
    got, glen = AudioPreprocessing(normalize=False)(t(x), t(lengths))
    assert got.shape == want.shape == (2, 80, 51)
    _close(got, want)
    _close(glen, wlen, 0)


def test_ctc_greedy_collapse_matches():
    rng = np.random.RandomState(9)
    preds = rng.randint(0, 4, size=(3, 20)).astype(np.int32)
    lengths = np.array([20, 11, 1], np.int32)
    wt, wl = jax_collapse(jnp.asarray(preds), jnp.asarray(lengths))
    gt, gl = ctc_greedy_collapse(t(preds).long(), t(lengths))
    _close(gt, wt, 0)
    _close(gl, wl, 0)
