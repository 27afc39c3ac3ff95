"""The port's remaining layers and blocks against the JAX package:
`ConvTranspose` (1-3 d), the global pools, `pixelcnn_mask` in a masked
conv, `GroupNorm`, `InstanceNorm`, `LSTM` (layers, bidirectional), the
norm and layer registries, the activations `identity` / `tanh_glu`, the
`MultiLayerPerceptron`, `InceptionModule` and `ConvTransposeNeuralNetwork`
blocks, and the ResNet family (the bottleneck block, ResNet34 and ResNet50
with stem and head).

Sizes are small, fp32 on the CPU, weights drawn with numpy for the JAX
variables' shapes and carried into the port by `params_from_jax`. The JAX
layers are channels-last; the port's convolutions and channel norms are
channels-first, so inputs and outputs are moved between the layouts.
Tolerance: 1e-4 (ResNet50's logits 1e-4 of their largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import conformer as jconf
from avec_tpu.models import resnet as jres
from avec_tpu.ops import activations as jact
from avec_tpu.ops import layers as jl
from avec_tpu_torch.convert import params_from_jax
from avec_tpu_torch.models import conformer as pconf
from avec_tpu_torch.models import resnet as pres
from avec_tpu_torch.ops import activations as pact
from avec_tpu_torch.ops import layers as pl

from test_torch_support import init_variables, port_state, t

torch.set_num_threads(1)
TOL = 1e-4


def _cf(x):
    """channels-last numpy -> channels-first tensor"""
    return t(np.moveaxis(x, -1, 1))


def _cl(y):
    """channels-first tensor -> channels-last numpy"""
    return np.moveaxis(y.detach().numpy(), 1, -1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("ndim,ks,st,pad,opad", [
    (1, 3, 2, 1, 1), (1, 4, 3, 0, 0), (2, (3, 2), (2, 1), (1, 0), (1, 0)),
    (3, 2, 2, 0, 1)])
def test_conv_transpose_matches_jax(ndim, ks, st, pad, opad):
    """(T - 1) s - 2p + k + op per axis, values 1e-4."""
    shape = (2,) + (5, 6, 4)[:ndim] + (3,)
    x = np.random.RandomState(ndim).randn(*shape).astype(np.float32)
    jmod = jl.ConvTranspose(features=4, kernel_size=ks, ndim=ndim,
                            strides=st, padding=pad, output_padding=opad)
    params, _ = init_variables(jmod, x)
    port = pl.ConvTranspose(3, 4, ks, ndim=ndim, stride=st, padding=pad,
                            output_padding=opad)
    port.load_state_dict(port_state(params, wrap="ConvTranspose_0",
                                    strip="ConvTranspose_0."), strict=True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = port(_cf(x))
    tup = lambda v: v if isinstance(v, tuple) else (v,) * ndim
    size = [(n - 1) * s - 2 * p + k + o for n, s, p, k, o in zip(
        shape[1:-1], tup(st), tup(pad), tup(ks), tup(opad))]
    assert list(got.shape[2:]) == size == list(want.shape[1:-1])
    _close(_cl(got), want)


def test_global_pools_and_pixelcnn_mask_match_jax():
    x = np.random.RandomState(0).randn(2, 4, 5, 3).astype(np.float32)
    _close(pl.global_avg_pool(t(x)).numpy(), jl.global_avg_pool(x))
    _close(pl.global_max_pool(t(x)).numpy(), jl.global_max_pool(x))
    _close(pl.global_avg_pool(t(x), axes=(1,)).numpy(),
           jl.global_avg_pool(x, axes=(1,)))
    for ks, kind in (((3, 3), "A"), ((5, 5), "B"), ((3, 5, 3), "A")):
        np.testing.assert_array_equal(pl.pixelcnn_mask(ks, kind),
                                      jl.pixelcnn_mask(ks, kind))
    # the mask in a conv: the kernel taps at and after the centre unused
    mask = jl.pixelcnn_mask((3, 3), "A")
    jmod = jl.Conv(features=4, kernel_size=3, ndim=2, kernel_mask=mask)
    params, _ = init_variables(jmod, x)
    port = pl.Conv(3, 4, 3, ndim=2, kernel_mask=pl.pixelcnn_mask((3, 3)))
    port.load_state_dict(port_state(params, wrap="conv_0", strip="conv_0."),
                         strict=True)
    assert "kernel_mask" not in port.state_dict()
    _close(_cl(port(_cf(x))), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_matches_jax(groups):
    x = (np.random.RandomState(groups).randn(2, 5, 6, 8) * 2 + 1).astype(
        np.float32)
    jmod = jl.GroupNorm(num_groups=groups)
    params, _ = init_variables(jmod, x)
    port = pl.GroupNorm(8, num_groups=groups)
    port.load_state_dict(port_state(params), strict=True)
    _close(_cl(port(_cf(x))), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(affine):
    x = (np.random.RandomState(1).randn(2, 5, 6, 4) * 3 - 1).astype(np.float32)
    jmod = jl.InstanceNorm(affine=affine)
    params, _ = init_variables(jmod, x)
    port = pl.InstanceNorm(4, affine=affine)
    port.load_state_dict(port_state(params), strict=True)
    _close(_cl(port(_cf(x))), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("layers,bidir", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_lstm_matches_jax(layers, bidir):
    """The gates i, f, g, o of flax's OptimizedLSTMCell in torch's stacked
    weights, the reverse direction in time order, forward first."""
    x = np.random.RandomState(layers).randn(2, 7, 6).astype(np.float32)
    jmod = jl.LSTM(hidden_size=5, num_layers=layers, bidirectional=bidir)
    params, _ = init_variables(jmod, x)
    port = pl.LSTM(6, 5, num_layers=layers, bidirectional=bidir)
    sd = params_from_jax(params, bidirectional_lstm=bidir)
    port.load_state_dict(sd, strict=True)
    assert all(not sd[k].any() for k in sd if k.startswith("bias_ih"))
    got = port(t(x))
    assert tuple(got.shape) == (2, 7, 5 * (1 + bidir))
    _close(got.detach().numpy(), jmod.apply({"params": params}, x))


def test_registries_and_activations():
    assert set(pl.norm_dict) == set(jl.norm_dict)
    assert set(pl.layer_dict) == set(jl.layer_dict)
    assert set(pact.act_dict) == set(jact.act_dict)
    assert isinstance(pl.layer_dict["ConvTranspose2d"](3, 4, 3),
                      pl.ConvTranspose)
    assert pl.layer_dict["ConvTranspose2d"](3, 4, 3).ndim == 2
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    assert pact.get_act("Identity")(t(x)) is not None
    np.testing.assert_array_equal(pact.identity(t(x)).numpy(), x)
    for name in pact.act_dict:
        _close(pact.get_act(name)(t(x)).numpy(), jact.get_act(name)(x), 1e-6)
    _close(pact.tanh_glu(t(x)).numpy(), jact.tanh_glu(x), 1e-6)
    spec = {"class": "GLU", "params": {"axis": 0}}
    x2 = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    _close(pact.get_act(spec)(t(x2)).numpy(), jact.get_act(spec)(x2), 1e-6)


@pytest.mark.parametrize("norm", [None, "LayerNorm", "InstanceNorm2d",
                                  "GroupNorm"])
def test_multi_layer_perceptron_matches_jax(norm):
    """(The JAX MLP cannot take "BatchNorm1d": it calls the BatchNorm
    without use_running_average, which flax then refuses.)"""
    x = np.random.RandomState(2).randn(2, 3, 8).astype(np.float32)
    jmod = jconf.MultiLayerPerceptron(dim_layers=[32, 64], norm=norm,
                                      act_fun="GELU")
    params, stats = init_variables(jmod, x)
    port = pconf.MultiLayerPerceptron(8, [32, 64], norm=norm, act_fun="GELU")
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    _close(port(t(x)).detach().numpy(), jmod.apply(variables, x))


def test_inception_module_matches_jax():
    """The four branches in their channel order (c0 | c2 | c4 | c5), eval
    BatchNorm with seeded running statistics."""
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32)
    jmod = jconf.InceptionModule(out_channels=[2, 3, 4, 5, 6, 7])
    params, stats = init_variables(jmod, x)
    port = pconf.InceptionModule(3, [2, 3, 4, 5, 6, 7])
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    got = port(_cf(x))
    assert got.shape[1] == 2 + 4 + 6 + 7
    _close(_cl(got), jmod.apply({"params": params, "batch_stats": stats}, x))


@pytest.mark.parametrize("norm", [None, "BatchNorm2d", "InstanceNorm2d"])
def test_conv_transpose_network_matches_jax(norm):
    """One kernel size, stride and padding for both layers: the JAX module's
    per-layer lists arrive as tuples (flax freezes list attributes), so
    there a list is one N-d value for every layer."""
    x = np.random.RandomState(4).randn(2, 4, 5, 6).astype(np.float32)
    kw = dict(kernel_size=3, strides=2, padding=1, output_padding=1,
              norm=norm)
    jmod = jconf.ConvTransposeNeuralNetwork(dim_layers=[4, 5], **kw)
    params, stats = init_variables(jmod, x)
    port = pconf.ConvTransposeNeuralNetwork(6, [4, 5], **kw)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    lengths = torch.tensor([4, 3])
    got, got_len = port(_cf(x), lengths)
    assert got_len is lengths
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    _close(_cl(got), jmod.apply(variables, x))


def test_conv_transpose_network_takes_per_layer_lists():
    """A list is one value per layer, as the reference's modules.py reads
    it: the stack equals its layers applied one after another."""
    net = pconf.ConvTransposeNeuralNetwork(
        6, [4, 5], kernel_size=[3, 2], strides=[2, 1], padding=[1, 0],
        output_padding=[1, 0])
    pl.init_params(net, torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 4, 5, generator=torch.Generator().manual_seed(1))
    y = torch.relu(net.convt_1(torch.relu(net.convt_0(x))))
    assert net.convt_0.kernel_size == (3, 3)
    assert net.convt_1.stride == (1, 1)
    torch.testing.assert_close(net(x), y, rtol=0, atol=0)


@pytest.mark.parametrize("ratio,stride", [(1, 1), (2, 2), (4, 1)])
def test_bottleneck_block_matches_jax(ratio, stride):
    """Eval (running statistics) and train mode (batch statistics)."""
    x = np.random.RandomState(5).randn(2, 8, 8, 16).astype(np.float32)
    jmod = jres.ResNetBottleneckBlock(out_features=32, bottleneck_ratio=ratio,
                                      strides=(stride, stride))
    params, stats = init_variables(jmod, x)
    port = pres.ResNetBottleneckBlock(16, 32, ratio, stride)
    # a block_0 at the root is a ResNet's first block
    sd = params_from_jax({"block_0": params}, {"block_0": stats})
    port.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()},
                         strict=True)
    variables = {"params": params, "batch_stats": stats}
    _close(_cl(port(_cf(x))), jmod.apply(variables, x))
    want, _ = jmod.apply(variables, x, deterministic=False,
                         mutable=["batch_stats"])
    _close(_cl(port.train()(_cf(x))), want)


@pytest.mark.parametrize("model", ["ResNet34", "ResNet50"])
def test_resnet_with_stem_and_head_matches_jax(model):
    """The whole network at 64 x 64 x 3 with its stem and head, eval with
    seeded running statistics: logits 1e-4 of their largest entry."""
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    jmod = jres.ResNet(model=model, dim_output=10)
    params, stats = init_variables(jmod, x)
    port = pres.ResNet(model, dim_output=10)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a))(
        {"params": params, "batch_stats": stats}, x))
    got = port(_cf(x)).detach().numpy()
    assert got.shape == (2, 10)
    _close(got, want, TOL * np.abs(want).max())


def test_resnet_without_head_returns_the_last_stage():
    port = pres.ResNet("ResNet18", include_stem=False, include_head=False)
    y = port(torch.zeros(1, 64, 8, 8))
    assert tuple(y.shape) == (1, 512, 1, 1) and port.stem is None
