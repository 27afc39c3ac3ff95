"""Port video stem and the BN+ReLU+pool kernel (K5) vs the JAX package.

The plain `bn_relu_pool` against the Pallas kernel in interpret mode, and the
port's FusedVideoStem (both modes) against the JAX FusedVideoStem in eval,
to 2e-5 as tests/test_pallas_stem.py uses. The CUDA kernel itself is held
against the plain version in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avec_tpu.models.encoders import FusedVideoStem as JaxStem
from avec_tpu.ops.pallas_stem import bn_relu_pool as jax_bn_relu_pool
from avec_tpu_torch.models.encoders import FusedVideoStem
from avec_tpu_torch.ops.stem import bn_relu_pool

from test_torch_support import init_variables, port_state, t

TOL = 2e-5
torch.set_num_threads(1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               np.asarray(want), rtol=0, atol=tol)


def _ab(rng, c=64):
    return (rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32) * 0.2)


def test_plain_bn_relu_pool_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    y = rng.randn(6, 44, 44, 64).astype(np.float32)
    a, b = _ab(rng)
    want = jax_bn_relu_pool(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b),
                            interpret=True)
    got = bn_relu_pool(t(y), t(a), t(b))
    assert got.shape == want.shape == (6, 22, 22, 64)
    _close(got, want)


@pytest.mark.parametrize("mode", ["pallas", "2d"])
@pytest.mark.parametrize("frames", [5, 3])
def test_video_stem_matches(mode, frames):
    """Eval forward from the same conv/BN parameters and running stats; the
    JAX pallas path pads T=3 to a block multiple internally."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, frames, 88, 88, 1) * 0.5).astype(np.float32)
    jstem = JaxStem(use_pallas=(mode == "pallas"), interpret=True)
    params, stats = init_variables(jstem, x, deterministic=True, seed=2)
    want = jstem.apply({"params": params, "batch_stats": stats}, x,
                       deterministic=True)
    stem = FusedVideoStem(mode)
    stem.load_state_dict(port_state(params, stats, wrap="front_end_stem",
                                    strip="front_end.0."))
    got = stem(t(x))
    assert got.shape == want.shape == (2 * frames, 22, 22, 64)
    _close(got, want)
