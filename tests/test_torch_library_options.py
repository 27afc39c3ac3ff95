"""The module options of the JAX library held against the JAX package, fp32
on the CPU, in training mode (batch statistics; dropout off, so both sides
compute one function) and in eval mode: the conformer block and module
variants (conformer.py:86-451), the stack's `batch_norm`, the Transformer
options and `GPTNet(compute_dtype=)` (transformer.py:58-167), the ResNet
block options (resnet.py:43-117), `ConvNeuralNetwork(norm=, drop_rate=,
weight_init=, bias_init=)` (conformer.py:728-778), `MultiHeadAttention(
output_proj=)`, `RelPos1dMultiHeadAttention(causal=)`, `BatchNorm(frozen=)`,
`Linear(dtype=)`, the spectrogram's `win_length`, `NativeBeamDecoder(
cutoff_prob=)`, `save_checkpoint(extra=)` and `CorpusLM(download=)`.

Tolerance: max abs 1e-4 for outputs, input and parameter gradients and
updated BN statistics (bf16 `compute_dtype`: 2e-2 of the largest logit; the
power spectrum: 1e-4 of its largest value). Weights are drawn for the JAX
trees and carried over by `params_from_jax`; every variant's state also
goes back to the JAX layout with `state_to_jax` bit for bit.

The fused gates: with the AVEC_TPU_FUSED_* switches on, each variant takes
the fused kernels in the port exactly where the JAX module takes its
Pallas kernels (conformer.py:103-107, :153-174, :248-252); the kernels'
entry points are replaced by recorders on both sides.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import conformer as jc
from avec_tpu.models import resnet as jr
from avec_tpu.models import transformer as jt
from avec_tpu.ops import attention as jatt
from avec_tpu.ops import audio as jaudio
from avec_tpu.ops import layers as jlayers
from avec_tpu.ops.masks import padding_mask as jax_padding_mask
from avec_tpu.train import checkpoint as jckpt
from avec_tpu_torch.convert import params_from_jax, state_to_jax
from avec_tpu_torch.models import conformer as pc
from avec_tpu_torch.models import resnet as pr
from avec_tpu_torch.models import transformer as pt
from avec_tpu_torch.ops import attention as patt
from avec_tpu_torch.ops import audio as paudio
from avec_tpu_torch.ops import layers as players
from avec_tpu_torch.ops.masks import padding_mask

from test_torch_support import init_variables, t

TOL = 1e-4
MODES = ["train", "eval"]
ATT = {"class": "RelPos1dMultiHeadAttention", "params": {"num_heads": 4}}
torch.set_num_threads(1)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _tree_close(got, want):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        _close(leaf, flat_want[path])


def _load(port, params, stats, wrap, strip):
    """The JAX trees, wrapped in the scopes `wrap` (outermost first), into
    `port` (strict), and the port's state back in the JAX layout: equal."""
    for name in reversed(wrap):
        params = {name: params}
        stats = {name: stats} if stats else stats
    sd = params_from_jax(params, stats or None)
    port.load_state_dict({k[len(strip):]: v for k, v in sd.items()},
                         strict=True)
    back = {strip + k: v for k, v in port.state_dict().items()}
    got_p, got_s = state_to_jax(back, params, stats or None)
    for got, want in ((got_p, params), (got_s, stats or {})):
        for path, leaf in jax.tree_util.tree_leaves_with_path(got):
            np.testing.assert_array_equal(
                leaf, dict(jax.tree_util.tree_leaves_with_path(want))[path])
    return port


def _grads_close(port, params, want_gp, wrap, strip):
    """The port's parameter gradients (a detached bias: an exact zero, as
    JAX's) in the JAX layout against JAX's."""
    grads = {strip + n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in port.named_parameters()}
    for name in reversed(wrap):
        params = {name: params}
        want_gp = {name: want_gp}
    _tree_close(state_to_jax(grads, params)[0], want_gp)


def _train_pair(jmod, variables, x, g, call, port_call, port, wrap, strip,
                has_stats):
    """Training mode, both sides: outputs, the input and parameter
    gradients of sum(y * g), and the updated BN statistics."""
    params, stats = variables

    def loss(p, xx):
        v = {"params": p, "batch_stats": stats} if has_stats else {"params": p}
        y, new = jmod.apply(v, xx, mutable=["batch_stats"], **call)
        return jnp.sum(y * g), (y, new.get("batch_stats", {}))

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port.train()
    xt = t(x).requires_grad_(True)
    y = port_call(port, xt)
    assert tuple(y.shape) == tuple(want_y.shape)
    (y * t(g)).sum().backward()
    _close(y, want_y)
    _close(xt.grad, want_gx)
    _grads_close(port, params, want_gp, wrap, strip)
    if has_stats:
        back = {strip + k: v for k, v in port.state_dict().items()}
        wp, ws = params, want_stats
        for name in reversed(wrap):
            wp, ws = {name: wp}, {name: ws}
        _tree_close(state_to_jax(back, wp, ws)[1], ws)


def _eval_pair(jmod, variables, x, call, port_call, port, has_stats):
    params, stats = variables
    v = {"params": params, "batch_stats": stats} if has_stats \
        else {"params": params}
    want = jmod.apply(v, jnp.asarray(x), **call)
    port.eval()
    with torch.no_grad():
        got = port_call(port, t(x))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


# ----------------------------------------------------- conformer variants
BLOCKS = {
    # (B, T, D) (2, 8, 16) -> (2, 16, 24): ConvTranspose depthwise conv
    # and a strided 1x1 ConvTranspose residual
    "transposed_new_width": dict(dim_model=16, dim_expand=24, conv_stride=2,
                                 transposed=True),
    # (2, 8, 16) -> (2, 16, 16): a nearest-neighbour residual
    "transposed_same_width": dict(dim_model=16, dim_expand=16, conv_stride=2,
                                  transposed=True),
    # a LayerNorm after the depthwise conv, whose bias then trains
    "no_batch_norm": dict(dim_model=16, dim_expand=16, batch_norm=False),
    "relu_no_block_norm_no_inner_dropout": dict(
        dim_model=16, dim_expand=16, act_fun="ReLU", block_norm=False,
        inner_dropout=False),
    "strided_no_batch_norm_relu": dict(dim_model=16, dim_expand=24,
                                       conv_stride=2, batch_norm=False,
                                       act_fun="ReLU"),
}


def _port_block(kw):
    kw = dict(kw)
    return pc.ConformerBlock(kw.pop("dim_model"), kw.pop("dim_expand"), 4,
                             ATT, drop_rate=0.0, kernel_size=5,
                             fused_att=False, fused_conv=False,
                             fused_ffn=False, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(BLOCKS))
def test_conformer_block_variant_matches_jax(variant, mode):
    kw = BLOCKS[variant]
    rng = np.random.RandomState(1)
    tt = 8
    x = rng.randn(2, tt, kw["dim_model"]).astype(np.float32)
    lengths = np.array([8, 5], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), tt)
    jmod = jc.ConformerBlock(ff_ratio=4, att_params=ATT, drop_rate=0.0,
                             kernel_size=5, **kw)
    params, stats = init_variables(jmod, x, mask, seed=2)
    port = _load(_port_block(kw), params, stats, ["block_0"],
                 "conformer_blocks.0.")
    pmask = padding_mask(t(lengths), tt)
    port_call = lambda m, xx: m(xx, mask=pmask)
    if mode == "eval":
        _eval_pair(jmod, (params, stats), x, dict(mask=mask), port_call,
                   port, True)
        return
    stride = kw.get("conv_stride", 1)
    t_out = tt * stride if kw.get("transposed") else -(-tt // stride)
    g = rng.randn(2, t_out, kw["dim_expand"]).astype(np.float32)
    _train_pair(jmod, (params, stats), x, g,
                dict(mask=mask, deterministic=False), port_call, port,
                ["block_0"], "conformer_blocks.0.", True)
    if not kw.get("batch_norm", True):
        # the depthwise conv's bias trains without a BN after it
        assert port.conv_module.layers["3"].bias.grad.abs().max() > 0


FFN_ATT = {
    "ffn_no_prenorm": (
        lambda: jc.FeedForwardModule(dim_model=16, dim_ffn=64, drop_rate=0.0,
                                     prenorm=False),
        lambda: pc.FeedForwardModule(16, 64, 0.0, fused_ffn=False,
                                     prenorm=False), "ff_module"),
    "ffn_relu_no_inner_dropout": (
        lambda: jc.FeedForwardModule(dim_model=16, dim_ffn=64, drop_rate=0.0,
                                     act_fun="ReLU", inner_dropout=False),
        lambda: pc.FeedForwardModule(16, 64, 0.0, fused_ffn=False,
                                     act_fun="ReLU", inner_dropout=False),
        "ff_module"),
    "attention_residual": (
        lambda: jc.AttentionModule(dim_model=16, att_params=ATT,
                                   drop_rate=0.0, residual=True),
        lambda: pc.AttentionModule(16, ATT, 0.0, fused_att=False,
                                   residual=True), "self_att_module"),
    "conv_module_relu": (
        lambda: jc.ConvolutionModule(dim_model=16, dim_expand=16,
                                     drop_rate=0.0, kernel_size=5,
                                     act_fun="ReLU"),
        lambda: pc.ConvolutionModule(16, 16, 1, 5, "same", 0.0,
                                     fused_conv=False, act_fun="ReLU"),
        "conv_module"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(FFN_ATT))
def test_module_variant_matches_jax(variant, mode):
    make_jax, make_port, scope = FFN_ATT[variant]
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 16).astype(np.float32)
    jmod = make_jax()
    params, stats = init_variables(jmod, x, seed=4)
    port = _load(make_port(), params, stats, [scope], scope + ".")
    has_stats = bool(stats)
    if mode == "eval":
        _eval_pair(jmod, (params, stats), x, {}, lambda m, xx: m(xx), port,
                   has_stats)
        return
    g = rng.randn(2, 7, 16).astype(np.float32)
    _train_pair(jmod, (params, stats), x, g, dict(deterministic=False),
                lambda m, xx: m(xx), port, [scope], scope + ".", has_stats)


@pytest.mark.parametrize("mode", MODES)
def test_stack_without_batch_norm_matches_jax(mode):
    """ConformerInterCTC(batch_norm=False): every block's convolution module
    with a LayerNorm; the InterCTC tap and the strided boundary."""
    rng = np.random.RandomState(5)
    tt = 9
    x = rng.randn(2, tt, 16).astype(np.float32)
    lengths = np.array([9, 4], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), tt)
    kw = dict(dim_model=[16, 24], num_blocks=[2, 1], interctc_blocks=[1],
              vocab_size=8, kernel_size=5, drop_rate=0.0, batch_norm=False)
    jmod = jc.ConformerInterCTC(att_params=ATT, **kw)
    params, stats = init_variables(jmod, x, jnp.asarray(lengths), mask,
                                   seed=6)
    assert not stats
    port = _load(pc.ConformerInterCTC(att_params=ATT, fused_att=False,
                                      fused_conv=False, fused_ffn=False,
                                      **kw), params, stats, [], "")
    port.train() if mode == "train" else port.eval()
    want, _, want_inter = jmod.apply({"params": params}, x,
                                     jnp.asarray(lengths), mask,
                                     deterministic=mode == "eval")
    got, _, inter = port(t(x), t(lengths), padding_mask(t(lengths), tt))
    _close(got, want)
    _close(inter["ctc_0"][0], want_inter["ctc_0"][0])


# ------------------------------------------------------------ transformer
def _transformer_pair(seed, **kw):
    att = {"class": "MultiHeadAttention",
           "params": {"num_heads": 2, "attn_drop_rate": 0.0,
                      "weight_init": "normal_02", "bias_init": "zeros"}}
    jmod = jt.Transformer(dim_model=16, num_blocks=2, att_params=att,
                          emb_drop_rate=0.0, drop_rate=0.0, **kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 6, 16).astype(np.float32)
    lengths = np.array([6, 4], np.int32)
    params, _ = init_variables(jmod, x, jnp.asarray(lengths), seed=seed)
    port = pt.Transformer(16, 2, att, emb_drop_rate=0.0, drop_rate=0.0, **kw)
    return jmod, params, _load(port, params, {}, ["transformer"],
                               "transformer."), x, lengths


TRANSFORMERS = {
    "post_norm_relu": dict(post_norm=True, act_fun="ReLU"),
    "not_causal_swish_inner_dropout": dict(causal=False, act_fun="Swish",
                                           inner_dropout=True),
    "post_norm_not_causal_default_inits": dict(
        post_norm=True, causal=False, weight_init="default",
        bias_init="default"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(TRANSFORMERS))
def test_transformer_options_match_jax(variant, mode):
    kw = TRANSFORMERS[variant]
    jmod, params, port, x, lengths = _transformer_pair(7, **kw)
    train = mode == "train"
    port.train() if train else port.eval()
    want = jmod.apply({"params": params}, x, jnp.asarray(lengths),
                      training=train)
    _close(port(t(x), t(lengths)), want)
    block = port.blocks[0]
    assert (block.norm is not None) == kw.get("post_norm", False)
    assert (port.layernorm is None) == kw.get("post_norm", False)
    lin = block.ff_module.layers["1"]
    assert (lin.weight_init, lin.bias_init) == (
        kw.get("weight_init", "normal_02"), kw.get("bias_init", "zeros"))


def test_gpt_compute_dtype_matches_jax():
    """GPTNet(compute_dtype=bfloat16): embeddings cast to bf16, the network
    in bf16 over fp32 parameters, against the JAX net at 2e-2 of the
    largest logit; float32 (the default) at 1e-4."""
    tiny = dict(vocab_size=33, max_pos_encoding=16, model="GPT-Tiny",
                drop_rate=0.0)
    ids = np.random.RandomState(8).randint(0, 33, size=(2, 9)).astype(np.int32)
    for jdt, pdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jnet = jt.GPTNet(compute_dtype=jdt, **tiny)
        params, _ = init_variables(jnet, jnp.asarray(ids), seed=9)
        port = pt.GPTNet(compute_dtype=pdt, **tiny)
        port.load_state_dict(params_from_jax(params), strict=True)
        port.eval()
        want = np.asarray(jnet.apply({"params": params}, jnp.asarray(ids)),
                          np.float32)
        with torch.no_grad():
            got = port(torch.from_numpy(ids).long())
        assert got.dtype == pdt
        tol = TOL if pdt == torch.float32 else 2e-2 * np.abs(want).max()
        _close(got, want, tol)


# ------------------------------------------------------------------ ResNet
RESNETS = {
    "basic_5x5_stride2_swish_split_act": (
        dict(out_features=24, kernel_size=(5, 5), strides=(2, 2),
             act_fun="Swish", joined_post_act=False),
        dict(kernel_size=5, strides=2, act_fun="Swish",
             joined_post_act=False), False),
    "basic_1x3_same_width": (
        dict(out_features=16, kernel_size=(1, 3)),
        dict(kernel_size=(1, 3)), False),
    "bottleneck_5x5_stride2_gelu": (
        dict(out_features=32, bottleneck_ratio=2, kernel_size=(5, 5),
             strides=(2, 2), act_fun="GELU", joined_post_act=False),
        dict(kernel_size=5, strides=2, act_fun="GELU",
             joined_post_act=False), True),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(RESNETS))
def test_resnet_block_options_match_jax(variant, mode):
    jkw, pkw, bottleneck = RESNETS[variant]
    rng = np.random.RandomState(10)
    x = rng.randn(2, 9, 9, 16).astype(np.float32)          # NHWC
    jmod = (jr.ResNetBottleneckBlock if bottleneck else jr.ResNetBlock)(**jkw)
    params, stats = init_variables(jmod, x, seed=11)
    port = (pr.ResNetBottleneckBlock(16, jkw["out_features"], 2, **pkw)
            if bottleneck else pr.ResNetBlock(16, jkw["out_features"], **pkw))
    wrap, strip = ["front_end_resnet", "block_0"], "front_end.3.blocks.0."
    port = _load(port, params, stats, wrap, strip)
    call = lambda m, xx: m(xx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    if mode == "eval":
        _eval_pair(jmod, (params, stats), x, {}, call, port, True)
        return
    s = jkw.get("strides", (1, 1))[0]
    g = rng.randn(2, -(-9 // s), -(-9 // s),
                  jkw["out_features"]).astype(np.float32)
    _train_pair(jmod, (params, stats), x, g, dict(deterministic=False), call,
                port, wrap, strip, True)


# ----------------------------------------------------- ConvNeuralNetwork
CNNS = {
    "no_norm_default": dict(norm=None),
    "batch_norm_swish": dict(norm="BatchNorm2d", act_fun="Swish"),
    # a tuple is one kernel / stride per axis for every layer
    "layer_norm_rectangular_kernel": dict(norm="LayerNorm",
                                          kernel_size=(3, 5),
                                          strides=(2, 1)),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(CNNS))
def test_conv_neural_network_options_match_jax(variant, mode):
    """Two layers (8, 12 channels) over (B, 10, 10, 3); lengths update by
    (len - 1) // 2 + 1 per layer."""
    kw = dict(CNNS[variant])
    ks = kw.pop("kernel_size", 3)
    strides = kw.pop("strides", 2)
    rng = np.random.RandomState(12)
    x = rng.randn(2, 10, 10, 3).astype(np.float32)
    lengths = np.array([10, 7], np.int32)
    jmod = jc.ConvNeuralNetwork(dim_layers=[8, 12], kernel_size=ks, ndim=2,
                                strides=strides, **kw)
    params, stats = init_variables(jmod, x, jnp.asarray(lengths), seed=13)
    port = pc.ConvNeuralNetwork(3, [8, 12], ks, ndim=2, strides=strides,
                                **kw)
    assert pc.ConvNeuralNetwork(3, [8], 3).layers[0][0].bias_stop_gradient \
        is False
    port = _load(port, params, stats, ["subsampling_module"],
                 "subsampling_module.")
    train = mode == "train"
    port.train() if train else port.eval()
    v = {"params": params, "batch_stats": stats} if stats else \
        {"params": params}
    (want, want_len), _ = jmod.apply(v, x, jnp.asarray(lengths),
                                     deterministic=not train,
                                     mutable=["batch_stats"])
    got, got_len = port(t(x).permute(0, 3, 1, 2), t(lengths))
    _close(got.permute(0, 2, 3, 1), want)
    _close(got_len, want_len, 0)


def test_conv_neural_network_per_layer_lists():
    """A list gives one kernel size / stride per layer (conformer.py:
    753-755). The JAX stack cannot take one: flax freezes its list fields
    into tuples, which it reads as one value per axis for every layer
    (ROADMAP section 3), so the port is held to the lists' meaning."""
    net = pc.ConvNeuralNetwork(3, [8, 12], [3, 5], strides=[2, 1])
    assert [layer[0].kernel_size for layer in net.layers] == [(3, 3), (5, 5)]
    assert [layer[0].stride for layer in net.layers] == [(2, 2), (1, 1)]
    y, lengths = net(torch.randn(2, 3, 10, 10), torch.tensor([10, 7]))
    assert tuple(y.shape) == (2, 12, 5, 5)
    assert lengths.tolist() == [3, 2]


def test_conv_neural_network_dropout_and_inits():
    """drop_rate: a Dropout after every activation in training (the JAX
    stack draws one per layer); weight_init / bias_init reach the convs."""
    net = pc.ConvNeuralNetwork(3, [8, 8], 3, drop_rate=0.5,
                               weight_init="xavier_uniform",
                               bias_init="zeros")
    conv = net.layers[0][0]
    assert (conv.weight_init, conv.bias_init) == ("xavier_uniform", "zeros")
    players.init_params(net, torch.Generator().manual_seed(0))
    assert float(conv.bias.detach().abs().max()) == 0.0
    x = torch.randn(2, 3, 6, 6)
    net.dropout.generator = torch.Generator().manual_seed(1)
    net.eval()
    y_eval = net(x)
    net.train()
    y_train = net(x)
    assert net.dropout.rate == 0.5
    assert not torch.equal(y_eval, y_train)
    assert pc.ConvNeuralNetwork(3, [8], 3).dropout is None


# ---------------------------------------------------------- small layers
def test_multi_head_attention_without_output_projection():
    rng = np.random.RandomState(14)
    x = rng.randn(2, 5, 16).astype(np.float32)
    jmod = jatt.MultiHeadAttention(dim_model=16, num_heads=4,
                                   output_proj=False, dim_kv=8)
    params, _ = init_variables(jmod, x, seed=15)
    assert "output_layer" not in params
    port = _load(patt.MultiHeadAttention(16, 4, output_proj=False, dim_kv=8),
                 params, {}, [], "")
    assert port.output_layer is None and port.dim_kv == 8
    _close(port(t(x)), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("tt", [6, 9])
def test_rel_pos_attention_causal_matches_jax(tt):
    rng = np.random.RandomState(16)
    x = rng.randn(2, tt, 16).astype(np.float32)
    lengths = np.array([tt, tt - 2], np.int32)
    mask = jax_padding_mask(jnp.asarray(lengths), tt)
    jmod = jatt.RelPos1dMultiHeadAttention(dim_model=16, num_heads=4,
                                           causal=True)
    params, _ = init_variables(jmod, x, mask, seed=17)
    port = _load(patt.RelPos1dMultiHeadAttention(16, 4, causal=True), params,
                 {}, [], "")
    want = jmod.apply({"params": params}, x, mask=mask)
    _close(port(t(x), mask=padding_mask(t(lengths), tt)), want)
    # use_flash never takes the causal layer through the flash kernel
    flash = patt.RelPos1dMultiHeadAttention(16, 4, use_flash=True,
                                            causal=True)
    flash.load_state_dict(port.state_dict())
    _close(flash(t(x), mask=padding_mask(t(lengths), tt)), want)


def test_batch_norm_frozen_matches_jax():
    """frozen=True: the running statistics in training too, unmoved."""
    rng = np.random.RandomState(18)
    x = rng.randn(4, 6, 8).astype(np.float32)           # channels last
    jmod = jlayers.BatchNorm(frozen=True)
    params, stats = init_variables(jmod, x, seed=19,
                                   use_running_average=False)
    port = _load(players.BatchNorm(8, frozen=True), params, stats, [], "")
    port.train()
    want, new = jmod.apply({"params": params, "batch_stats": stats}, x,
                           use_running_average=False, mutable=["batch_stats"])
    got = port(t(x).permute(0, 2, 1)).permute(0, 2, 1)
    _close(got, want)
    _close(port.running_mean, new["batch_stats"]["mean"])
    np.testing.assert_array_equal(port.running_var.numpy(),
                                  stats["var"])


def test_linear_dtype_matches_jax():
    rng = np.random.RandomState(20)
    x = rng.randn(3, 5, 8).astype(np.float32)
    jmod = jlayers.Linear(6, dtype=jnp.bfloat16)
    params, _ = init_variables(jmod, x, seed=21)
    port = _load(players.Linear(8, 6, dtype=torch.bfloat16), params, {}, [],
                 "")
    want = jmod.apply({"params": params}, x)
    got = port(t(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want)


@pytest.mark.parametrize("win_length", [320, 512])
def test_spectrogram_win_length_matches_jax(win_length):
    rng = np.random.RandomState(22)
    x = rng.randn(2, 3200).astype(np.float32)
    want = np.asarray(jaudio.power_spectrogram(jnp.asarray(x),
                                               win_length=win_length))
    got = paudio.power_spectrogram(t(x), win_length=win_length).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    xp = rng.randn(2, 2000).astype(np.float32)
    want = np.asarray(jaudio.spectrogram_frames(jnp.asarray(xp), 9,
                                                win_length=win_length))
    got = paudio.spectrogram_frames(t(xp), 9, win_length=win_length).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_native_cutoff_prob_prunes_as_specified():
    """NativeBeamDecoder(cutoff_prob=p) keeps, per frame, the tokens by
    probability until their sum passes p, and the blank: the same beams as
    the unpruned decoder on log-probs whose other tokens are set to a
    floor far below any kept path."""
    from avec_tpu_torch.decode.native import NativeBeamDecoder

    rng = np.random.RandomState(23)
    logits = rng.randn(12, 6).astype(np.float32) * 3.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    p = 0.8
    pruned = np.full_like(logp, -1e4)
    for i, row in enumerate(logp):
        cum = 0.0
        for c in np.argsort(-row, kind="stable"):
            pruned[i, c] = row[c]
            cum += np.exp(row[c])
            if cum > p:
                break
        pruned[i, 0] = row[0]
    want = NativeBeamDecoder(beam_size=4).decode(pruned, 12)
    got = NativeBeamDecoder(beam_size=4, cutoff_prob=p).decode(logp, 12)
    keep = lambda beams: [(pre, round(s, 4)) for pre, s in beams if s > -1e3]
    assert keep(got) == keep(want)
    assert keep(got) != keep(NativeBeamDecoder(beam_size=4).decode(logp, 12))


def test_save_checkpoint_extra_round_trips(tmp_path):
    """extra= comes back from the port's file, and from a JAX msgpack file
    written with extra=."""
    from avec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    extra = {"epoch": 3, "name": "av", "wer": [12.5, 10.0],
             "scale": torch.tensor([1.5, 2.0])}
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, {"w": torch.ones(2)}, model_step=7, extra=extra)
    got = load_checkpoint(path)
    assert got["extra"].keys() == extra.keys()
    assert torch.equal(got["extra"]["scale"], extra["scale"])
    assert got["extra"]["wer"] == [12.5, 10.0] and got["model_step"] == 7
    save_checkpoint(path, {"w": torch.ones(2)})
    assert load_checkpoint(path)["extra"] == {}
    jpath = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(jpath, {"params": {"head": {
        "kernel": np.ones((2, 3), np.float32)}}}, model_step=5,
        extra={"epoch": 3, "name": "av"})
    got = load_checkpoint(jpath)
    assert got["format"] == "jax" and got["model_step"] == 5
    assert got["extra"] == {"epoch": 3, "name": "av"}


def test_corpus_lm_download_raises_naming_the_file(tmp_path):
    from avec_tpu_torch.data.corpus_lm import CorpusLM

    corpus = str(tmp_path / "lm.txt")
    with pytest.raises(RuntimeError, match="librispeech-lm-norm.txt"):
        CorpusLM(2, None, download=True, corpus_path=corpus)
    with pytest.raises(RuntimeError, match=re.escape(corpus)):
        CorpusLM(2, None, download=True, corpus_path=corpus)


# ------------------------------------------------------------ fused gates
class _Taken(Exception):
    """Raised by a recorder in place of a fused kernel's entry point."""


def _recorder(calls, name):
    def record(*args, **kwargs):
        calls.append((name, kwargs.get("residual")))
        raise _Taken
    return record


GATES = {
    "ffn_default": (dict(kind="ffn"), dict(kind="ffn")),
    "ffn_no_prenorm": (dict(kind="ffn", prenorm=False),
                       dict(kind="ffn", prenorm=False)),
    "ffn_relu": (dict(kind="ffn", act_fun="ReLU"),
                 dict(kind="ffn", act_fun="ReLU")),
    "ffn_no_inner_dropout": (dict(kind="ffn", inner_dropout=False),
                             dict(kind="ffn", inner_dropout=False)),
    "att_residual": (dict(kind="att", residual=True),
                     dict(kind="att", residual=True)),
    "att_no_residual": (dict(kind="att", residual=False),
                        dict(kind="att", residual=False)),
    "conv_default": (dict(kind="conv"), dict(kind="conv")),
    "conv_transposed": (dict(kind="conv", transposed=True, stride=2),
                        dict(kind="conv", transposed=True, stride=2)),
    "conv_transposed_stride1": (dict(kind="conv", transposed=True),
                                dict(kind="conv", transposed=True)),
    "conv_no_batch_norm": (dict(kind="conv", batch_norm=False),
                           dict(kind="conv", batch_norm=False)),
    "conv_relu": (dict(kind="conv", act_fun="ReLU"),
                  dict(kind="conv", act_fun="ReLU")),
    "conv_strided": (dict(kind="conv", stride=2), dict(kind="conv", stride=2)),
}


def _gate_modules(spec):
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind == "ffn":
        return (jc.FeedForwardModule(dim_model=16, dim_ffn=64, drop_rate=0.1,
                                     **spec),
                pc.FeedForwardModule(16, 64, 0.1, **spec))
    if kind == "att":
        return (jc.AttentionModule(dim_model=16, att_params=ATT,
                                   drop_rate=0.1, **spec),
                pc.AttentionModule(16, ATT, 0.1, **spec))
    stride = spec.pop("stride", 1)
    return (jc.ConvolutionModule(dim_model=16, dim_expand=16, drop_rate=0.1,
                                 stride=stride, kernel_size=5, **spec),
            pc.ConvolutionModule(16, 16, stride, 5, "same", 0.1, **spec))


@pytest.mark.parametrize("variant", sorted(GATES))
def test_fused_gates_route_each_variant_as_jax(variant, monkeypatch):
    """With AVEC_TPU_FUSED_FFN / _ATT / _CONV=1, a training call takes the
    fused kernels in the port (the recorder in place of the fused entry
    point) exactly when the JAX module takes its Pallas kernels, with the
    same `residual`."""
    from avec_tpu.ops import pallas_attention_module, pallas_conv_module
    from avec_tpu.ops import pallas_ffn

    for var in ("FFN", "ATT", "CONV"):
        monkeypatch.setenv(f"AVEC_TPU_FUSED_{var}", "1")
    jax_calls, port_calls = [], []
    for mod, name in ((pallas_ffn, "fused_ffn_3d"),
                      (pallas_attention_module, "fused_attention_module_3d"),
                      (pallas_conv_module, "fused_conv_module_3d")):
        monkeypatch.setattr(mod, name, _recorder(jax_calls, name))
    for name in ("fused_ffn_3d", "fused_attention_module_3d",
                 "fused_conv_module_3d"):
        monkeypatch.setattr(pc, name, _recorder(port_calls, name))
    jspec, pspec = GATES[variant]
    jmod, port = _gate_modules(jspec)
    x = np.random.RandomState(24).randn(2, 7, 16).astype(np.float32)
    params, stats = init_variables(jmod, x, seed=25)
    try:
        jmod.apply({"params": params, "batch_stats": stats}, x,
                   deterministic=False, mutable=["batch_stats"],
                   rngs={"dropout": jax.random.PRNGKey(0)})
    except _Taken:
        pass
    port.train()
    port.seed_generator = torch.Generator().manual_seed(0)
    try:
        port(t(x))
    except _Taken:
        pass
    assert port_calls == jax_calls
    assert port.fused_eligible() == bool(jax_calls)


# ------------------------------------- the JAX converter on the variants
def _jax_round_trip(make_jax, make_port, args, wrap, strip):
    """The port's state_dict of the variant through the JAX package's
    convert_state_dict, against the JAX variables."""
    from avec_tpu.train.torch_convert import convert_state_dict

    jmod = make_jax()
    params, stats = init_variables(jmod, *args, seed=26)
    port = _load(make_port(), params, stats, wrap, strip)
    tree = {"params": params, "batch_stats": stats} if stats else \
        {"params": params}
    for name in reversed(wrap):
        tree = {k: {name: v} for k, v in tree.items()}
    template = jckpt.state_dict_flatten(tree)
    sd = {strip + k: v for k, v in port.state_dict().items()}
    flat, report = convert_state_dict(sd, template)
    assert not report["unexpected"] and set(flat) == set(template)
    for k, v in template.items():
        np.testing.assert_array_equal(flat[k], v)


_X16 = np.random.RandomState(27).randn(2, 6, 16).astype(np.float32)
JAX_CONVERTIBLE = {
    "block_relu_no_block_norm": (
        lambda: jc.ConformerBlock(dim_model=16, dim_expand=16, ff_ratio=4,
                                  att_params=ATT, drop_rate=0.0,
                                  kernel_size=5, act_fun="ReLU",
                                  block_norm=False, inner_dropout=False),
        lambda: _port_block(dict(dim_model=16, dim_expand=16, act_fun="ReLU",
                                 block_norm=False, inner_dropout=False)),
        (_X16,), ["block_0"], "conformer_blocks.0."),
    "ffn_no_prenorm": (*FFN_ATT["ffn_no_prenorm"][:2], (_X16,),
                       ["ff_module"], "ff_module."),
    "transformer_post_norm": (
        lambda: jt.Transformer(
            dim_model=16, num_blocks=2, post_norm=True, causal=False,
            att_params={"class": "MultiHeadAttention",
                        "params": {"num_heads": 2}}),
        lambda: pt.Transformer(16, 2, {"class": "MultiHeadAttention",
                                       "params": {"num_heads": 2}},
                               post_norm=True, causal=False),
        (_X16,), ["transformer"], "transformer."),
    "resnet_block_5x5": (
        lambda: jr.ResNetBlock(out_features=24, kernel_size=(5, 5),
                               strides=(2, 2)),
        lambda: pr.ResNetBlock(16, 24, strides=2, kernel_size=5),
        (np.random.RandomState(28).randn(2, 9, 9, 16).astype(np.float32),),
        ["front_end_resnet", "block_0"], "front_end.3.blocks.0."),
    "attention_without_output_projection": (
        lambda: jatt.MultiHeadAttention(dim_model=16, num_heads=4,
                                        output_proj=False),
        lambda: patt.MultiHeadAttention(16, 4, output_proj=False),
        (_X16,), [], ""),
}


@pytest.mark.parametrize("variant", sorted(JAX_CONVERTIBLE))
def test_jax_converter_maps_the_variants_back(variant):
    """The JAX package's convert_state_dict takes the port's state_dict of
    these variants back to the JAX variables bit for bit."""
    _jax_round_trip(*JAX_CONVERTIBLE[variant])


@pytest.mark.parametrize("variant,missing", [
    ("transposed_new_width", "ConvTranspose_0"),
    ("no_batch_norm", "LayerNorm_1")])
def test_jax_converter_has_no_rule_for_two_convolution_variants(variant,
                                                                missing):
    """The JAX converter's convolution-module map (torch_convert.py:98-100)
    has no ConvTranspose_0 and no LayerNorm_1, so it cannot take these
    variants back (ROADMAP section 3); the port's `state_to_jax` does, bit
    for bit (`_load`)."""
    kw = BLOCKS[variant]
    with pytest.raises(KeyError, match=missing):
        _jax_round_trip(
            lambda: jc.ConformerBlock(ff_ratio=4, att_params=ATT,
                                      drop_rate=0.0, kernel_size=5, **kw),
            lambda: _port_block(kw),
            (np.random.RandomState(29).randn(2, 8, 16).astype(np.float32),
             jax_padding_mask(jnp.asarray([8, 5]), 8)),
            ["block_0"], "conformer_blocks.0.")
