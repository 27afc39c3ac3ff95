"""Port conformer blocks, the InterCTC stack and the ResNet block vs the JAX
package, eval mode, fp32 on the CPU. Tolerance: max abs 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avec_tpu.models import conformer as jc
from avec_tpu.models import resnet as jr
from avec_tpu.ops.masks import padding_mask as jax_padding_mask
from avec_tpu_torch.models import conformer as pc
from avec_tpu_torch.models import resnet as pr
from avec_tpu_torch.ops.masks import padding_mask

from test_torch_support import init_variables, port_state, t

TOL = 1e-4
torch.set_num_threads(1)

ATT = {"class": "RelPos1dMultiHeadAttention", "params": {"num_heads": 4}}
PATCH = {"class": "RelPosPatch1dMultiHeadAttention",
         "params": {"num_heads": 4, "patch_size": 3}}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dim_in,dim_out,stride,att", [
    (16, 16, 1, ATT),      # stride 1
    (16, 24, 2, ATT),      # strided, new dim: strided pointwise conv_res
    (16, 16, 2, PATCH),    # strided, same dim: max-pool residual
])
def test_conformer_block_matches(dim_in, dim_out, stride, att):
    rng = np.random.RandomState(0)
    t_ = 13
    x = rng.randn(2, t_, dim_in).astype(np.float32)
    lengths = np.array([13, 6], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), t_)
    mod = jc.ConformerBlock(dim_model=dim_in, dim_expand=dim_out, ff_ratio=4,
                            att_params=att, drop_rate=0.1, conv_stride=stride)
    params, stats = init_variables(mod, x, mask, seed=1)
    want = mod.apply({"params": params, "batch_stats": stats}, x, mask=mask)
    port = pc.ConformerBlock(dim_in, dim_out, 4, att, conv_stride=stride)
    port.load_state_dict(port_state(params, stats, wrap="block_0",
                                    strip="conformer_blocks.0."))
    got = port(t(x), mask=padding_mask(t(lengths), t_))
    assert got.shape == want.shape
    _close(got, want)


def test_conformer_interctc_stack_matches():
    """Two stages with a strided boundary block and two InterCTC taps: the
    flat block list, re-strided masks/lengths and tap keys."""
    rng = np.random.RandomState(2)
    t_ = 11
    x = rng.randn(2, t_, 16).astype(np.float32)
    lengths = np.array([11, 4], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), t_)
    kw = dict(dim_model=[16, 24], num_blocks=[2, 2], interctc_blocks=[2, 3],
              vocab_size=8)
    mod = jc.ConformerInterCTC(att_params=ATT, loss_prefix="a_ctc", **kw)
    params, stats = init_variables(mod, x, jnp.asarray(lengths), mask, seed=3)
    want_x, want_len, want_inter = mod.apply(
        {"params": params, "batch_stats": stats}, x, jnp.asarray(lengths),
        mask)
    port = pc.ConformerInterCTC(att_params=ATT, loss_prefix="a_ctc", **kw)
    port.load_state_dict(port_state(params, stats))
    got_x, got_len, got_inter = port(t(x), t(lengths),
                                     padding_mask(t(lengths), t_))
    _close(got_x, want_x)
    _close(got_len, want_len, 0)
    assert sorted(got_inter) == sorted(want_inter) == ["a_ctc_1", "a_ctc_2"]
    for key in want_inter:
        _close(got_inter[key][0], want_inter[key][0])
        _close(got_inter[key][1], want_inter[key][1], 0)


@pytest.mark.parametrize("cin,cout,stride", [(8, 8, 1), (8, 16, 2)])
def test_resnet_block_matches(cin, cout, stride):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 9, 9, cin).astype(np.float32)
    mod = jr.ResNetBlock(out_features=cout, strides=(stride, stride))
    params, stats = init_variables(mod, x, seed=5)
    want = mod.apply({"params": params, "batch_stats": stats}, x)
    port = pr.ResNetBlock(cin, cout, stride)
    port.load_state_dict(port_state(
        {"block_0": params}, {"block_0": stats}, wrap="front_end_resnet",
        strip="front_end.3.blocks.0."))
    got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)
