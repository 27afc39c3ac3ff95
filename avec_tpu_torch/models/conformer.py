"""Conformer blocks and the InterCTC conformer stack (port of
avec_tpu/models/conformer.py), eval and training.

Sequences are (B, T, D); masks boolean (B, 1, 1, T); lengths int (B,).
Parameter names follow the reference state_dict: ff_module{1,2}.layers.{0,1,4},
self_att_module.{norm,attention}, conv_module.layers.{0,1,3,4,6}, conv_res,
norm; conformer_blocks.{i} and interctc_modules.{k} in the stack.

Training mode (`nn.Module.train()`): the feed-forward module runs as one
fused kernel per direction (`ops/ffn.py`) where `fused_ffn` is on, the
attention module as one fused kernel per direction
(`ops/attention_module.py`) where `fused_att` is on, and the convolution
module as two fused kernels per direction (`ops/conv_module.py`) where
`fused_conv` is on; the switches default to the JAX package's environment
variables, so by default training runs the unfused layers; dropout follows the
attention, convolution and feed-forward modules and opens the stack, the
convolution module's BatchNorm uses batch statistics and the depthwise conv's
bias is detached.

Streaming (eval, the causal configuration): `ConformerInterCTC.
stream_forward` runs one chunk with carried state, a per-block list of
{"att": {"K", "V"}, "conv": tail}: the attention modules take and return
their Transformer-XL key/value caches (`hidden`), the convolution modules
their depthwise conv's (k - 1)-frame input tails (`state`).

The library blocks `MultiLayerPerceptron`, `InceptionModule` and
`ConvTransposeNeuralNetwork` (conformer.py:677-820; no AVEC model uses them)
name their children as the JAX modules do (linear_0, BatchNorm_0, convt_0,
branch0, branch0_bn, ...).
"""

import os
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from avec_tpu_torch.models.remat import remat_call
from avec_tpu_torch.ops.activations import get_act, glu, swish
from avec_tpu_torch.ops.attention import (RelPos1dMultiHeadAttention,
                                          make_attention)
from avec_tpu_torch.ops.attention_module import (
    fused_attention_module_3d, fused_attention_module_3d_dp)
from avec_tpu_torch.ops.conv_module import (conv_module_params,
                                            fused_conv_module_3d,
                                            fused_conv_module_3d_dp)
from avec_tpu_torch.ops.ffn import fused_ffn_3d, fused_ffn_3d_dp
from avec_tpu_torch.ops.layers import (BatchNorm, Conv, ConvTranspose,
                                       Dropout, LayerNorm, Linear, norm_dict,
                                       upsample_nearest)
from avec_tpu_torch.ops.masks import downsample_mask, strided_lengths


def _indexed(mods: Dict[int, nn.Module]) -> nn.ModuleDict:
    """A ModuleDict keyed like the reference's nn.Sequential indices."""
    return nn.ModuleDict({str(i): m for i, m in mods.items()})


class FeedForwardModule(nn.Module):
    """Pre-norm FFN: LN(1e-6) -> Linear(d_ffn) -> act -> drop (inner) ->
    Linear(d) -> drop (conformer.py:86-139); `prenorm=False` leaves the
    LayerNorm out. `act_fun` names an activation of `ops/activations.py`:
    "Swish" (the conformer's) or "GELU" (the GPT's, with
    `inner_dropout=False` and the Linear inits "normal_02" / "zeros").

    With `fused_ffn` (None: the environment variable AVEC_TPU_FUSED_FFN) a
    (B, T, d) input in training mode goes through the fused kernel of
    `ops/ffn.py` where the JAX gate of conformer.py:103-107 lets it:
    training, pre-norm, 3-d input, Swish (the kernel computes swish) and
    inner dropout or no dropout at all; the 31-bit dropout seed is drawn
    from `seed_generator`, a CPU `torch.Generator` set by the owning model;
    with a `process_group` (data-parallel training) it goes through
    `fused_ffn_3d_dp`, which offsets that seed per rank. Otherwise, as the
    JAX package's default training step does (conformer.py:130-139), and
    always in eval, it runs the unfused layers with the generator's Dropout.
    `use_kernel=False` routes the fused path through its plain version;
    `regularize=False` turns dropout off."""

    def __init__(self, dim_model: int, dim_ffn: int, drop_rate: float = 0.1,
                 fused_ffn: Optional[bool] = None, act_fun: str = "Swish",
                 inner_dropout: bool = True, weight_init: str = "default",
                 bias_init: str = "default", prenorm: bool = True):
        super().__init__()
        inits = dict(weight_init=weight_init, bias_init=bias_init)
        layers = {1: Linear(dim_model, dim_ffn, **inits),
                  4: Linear(dim_ffn, dim_model, **inits)}
        if prenorm:
            layers[0] = LayerNorm(dim_model, 1e-6)
        self.layers = _indexed(dict(sorted(layers.items())))
        self.dropout = Dropout(drop_rate)
        self.drop_rate = drop_rate
        self.act_fun = act_fun
        self.inner_dropout = inner_dropout
        self.prenorm = prenorm
        self.fused_ffn = (_fused_ffn_enabled() if fused_ffn is None
                          else bool(fused_ffn))
        self.use_kernel = True
        self.regularize = True
        self.seed_generator = None
        self.process_group = None
        self.training = False

    def fused_eligible(self, ndim: int = 3) -> bool:
        """Whether a training-mode call with an input of `ndim` axes takes
        the fused kernels."""
        return (self.fused_ffn and self.prenorm and ndim == 3
                and self.act_fun == "Swish"
                and (self.inner_dropout or self.drop_rate == 0.0))

    def forward(self, x):
        lin1, lin2 = self.layers["1"], self.layers["4"]
        if self.training and self.fused_eligible(x.ndim):
            norm = self.layers["0"]
            rate = self.drop_rate if self.regularize else 0.0
            seed = _draw_seed(self.seed_generator) if rate > 0.0 else None
            fn, dp = _dp_route(fused_ffn_3d, fused_ffn_3d_dp,
                               self.process_group)
            return fn(x, norm.weight, norm.bias, lin1.weight, lin1.bias,
                      lin2.weight, lin2.bias, seed=seed, epsilon=norm.eps,
                      drop_rate=rate, deterministic=False,
                      use_kernel=self.use_kernel, **dp)
        if self.prenorm:
            x = self.layers["0"](x)
        x = get_act(self.act_fun)(lin1(x))
        if self.inner_dropout:
            x = self.dropout(x)
        return self.dropout(lin2(x))


def _fused_ffn_enabled() -> bool:
    """AVEC_TPU_FUSED_FFN=1 routes the feed-forward modules through the fused
    kernels in training (conformer.py:75-83)."""
    return os.environ.get("AVEC_TPU_FUSED_FFN", "") == "1"


def _fused_att_enabled() -> bool:
    """AVEC_TPU_FUSED_ATT=1 routes eligible attention modules through the
    fused kernels in training (conformer.py:65-72)."""
    return os.environ.get("AVEC_TPU_FUSED_ATT", "") == "1"


def _fused_conv_enabled() -> bool:
    """AVEC_TPU_FUSED_CONV=1 routes eligible convolution modules through the
    fused kernels in training (conformer.py:56-62)."""
    return os.environ.get("AVEC_TPU_FUSED_CONV", "") == "1"


def _draw_seed(generator) -> int:
    """A 31-bit dropout seed for a fused kernel, drawn on the CPU."""
    return int(torch.randint(0, 2 ** 31, (), generator=generator))


def _dp_route(fn, fn_dp, group):
    """(the fused entry point, its extra keyword arguments): the
    data-parallel form with its process group when there is one."""
    return (fn, {}) if group is None else (fn_dp, {"group": group})


class AttentionModule(nn.Module):
    """Pre-norm attention + dropout, + x with `residual` (conformer.py:
    142-221; the conformer block's module has none, it adds its own).

    With `fused_att` (None: the environment variable AVEC_TPU_FUSED_ATT) the
    module runs as one fused kernel per direction (`ops/attention_module.py`)
    where the JAX gate of conformer.py:153-174 lets it: training mode, a 3-d
    input, `RelPos1dMultiHeadAttention` itself (not the patch subclass) with
    `use_flash` off, and no mask or a key-padding mask (B, 1, 1, T). The
    lengths are the `lengths` argument, else the mask's row sums; the 31-bit
    dropout seed comes from `seed_generator` and a `process_group` selects
    the data-parallel form, as in `FeedForwardModule`. Eval always runs the
    unfused layers. `use_kernel=False` routes the fused path through its
    plain version; `regularize=False` turns its dropout off."""

    def __init__(self, dim_model: int, att_params: dict,
                 drop_rate: float = 0.1, fused_att: Optional[bool] = None,
                 residual: bool = True):
        super().__init__()
        self.residual = residual
        self.norm = LayerNorm(dim_model, 1e-6)
        self.attention = make_attention(dim_model, att_params)
        self.dropout = Dropout(drop_rate)
        self.drop_rate = drop_rate
        self.fused_att = (_fused_att_enabled() if fused_att is None
                          else bool(fused_att))
        self.use_kernel = True
        self.regularize = True
        self.seed_generator = None
        self.process_group = None
        self.training = False

    def fused_eligible(self, ndim: int = 3, mask=None) -> bool:
        """Whether a training-mode call with an input of `ndim` axes and this
        mask takes the fused kernels."""
        att = self.attention
        return (self.fused_att and ndim == 3
                and type(att) is RelPos1dMultiHeadAttention
                and not att.use_flash and not att.causal
                and att.output_layer is not None
                and (mask is None or (mask.ndim == 4 and mask.shape[2] == 1))
                and att.dim_model % att.num_heads == 0
                and att.dim_model % 2 == 0)

    def forward(self, x, mask=None, lengths=None, hidden=None,
                return_hidden: bool = False):
        """With `return_hidden` (streaming, Transformer-XL attention) the
        layer takes the key/value cache `hidden` and the call returns (out,
        the layer's new cache) (conformer.py:177-220)."""
        if return_hidden:
            out, new_hidden = self.attention(
                self.norm(x), mask=mask, hidden=hidden, return_hidden=True)
            out = self.dropout(out)
            return (out + x if self.residual else out), new_hidden
        if self.training and self.fused_eligible(x.ndim, mask):
            att = self.attention
            rate = self.drop_rate if self.regularize else 0.0
            seed = _draw_seed(self.seed_generator) if rate > 0.0 else None
            if lengths is None and mask is not None:
                lengths = mask[:, 0, 0, :].sum(dim=-1).to(torch.int32)
            fn, dp = _dp_route(fused_attention_module_3d,
                               fused_attention_module_3d_dp,
                               self.process_group)
            return fn(
                x, self.norm.weight, self.norm.bias,
                att.query_layer.weight, att.query_layer.bias,
                att.key_layer.weight, att.key_layer.bias,
                att.value_layer.weight, att.value_layer.bias,
                att.pos_layer.weight, att.pos_layer.bias,
                att.output_layer.weight, att.output_layer.bias,
                num_heads=att.num_heads, lengths=lengths, seed=seed,
                drop_rate=rate, deterministic=False, residual=self.residual,
                ln_eps=self.norm.eps, use_kernel=self.use_kernel, **dp)
        out = self.dropout(self.attention(self.norm(x), mask=mask,
                                          lengths=lengths))
        return out + x if self.residual else out


class ConvolutionModule(nn.Module):
    """LN -> pointwise 2E -> GLU -> depthwise k (stride) -> BN -> act
    -> pointwise E -> drop; channels-first inside, (B, T, D) at the boundary
    (conformer.py:224-318). The depthwise conv feeds the BN, so its bias is
    detached in training. `batch_norm=False` puts a LayerNorm (eps 1e-5,
    over the channels) in place of the BN, and the depthwise bias then
    trains; `transposed` puts a ConvTranspose of E channels in place of the
    depthwise conv (padding (k - 1) // 2, output padding stride - 1: T times
    the stride frames out); `act_fun` names the activation.

    With `fused_conv` (None: the environment variable AVEC_TPU_FUSED_CONV)
    the module runs as the fused kernels of `ops/conv_module.py` where the
    JAX gate of conformer.py:248-253 lets it: training mode, stride 1,
    padding "same" or "causal", a 3-d input, not transposed, BatchNorm and
    Swish. The batch statistics the kernels return move
    the BatchNorm's running statistics; the 31-bit dropout seed comes from
    `seed_generator`, as in `FeedForwardModule`. With a `process_group`
    (data-parallel training) the fused route is the K3dp path
    (`fused_conv_module_3d_dp`, statistics over the global batch) and the
    unfused route's BatchNorm syncs its statistics. Eval always runs the
    unfused layers. `use_kernel=False` routes the fused path through its
    plain stages; `regularize=False` turns its dropout off."""

    def __init__(self, dim_model: int, dim_expand: int, stride: int = 1,
                 kernel_size: int = 15, padding: str = "same",
                 drop_rate: float = 0.1, fused_conv: Optional[bool] = None,
                 act_fun: str = "Swish", batch_norm: bool = True,
                 transposed: bool = False):
        super().__init__()
        if transposed:
            depthwise = ConvTranspose(
                dim_expand, dim_expand, kernel_size, ndim=1, stride=stride,
                padding=(kernel_size - 1) // 2,
                output_padding=max(stride - 1, 0))
        else:
            depthwise = Conv(dim_expand, dim_expand, kernel_size, ndim=1,
                             stride=stride, padding=padding,
                             groups=dim_expand, bias_stop_gradient=batch_norm)
        self.layers = _indexed({
            0: LayerNorm(dim_model, 1e-6),
            1: Conv(dim_model, 2 * dim_expand, 1, ndim=1),
            3: depthwise,
            4: BatchNorm(dim_expand) if batch_norm else LayerNorm(dim_expand),
            6: Conv(dim_expand, dim_expand, 1, ndim=1)})
        self.dropout = Dropout(drop_rate)
        self.drop_rate = drop_rate
        self.stride = stride
        self.padding = padding
        self.act_fun = act_fun
        self.batch_norm = batch_norm
        self.transposed = transposed
        self.fused_conv = (_fused_conv_enabled() if fused_conv is None
                           else bool(fused_conv))
        self.use_kernel = True
        self.regularize = True
        self.seed_generator = None
        self.process_group = None
        self.training = False

    def fused_eligible(self, ndim: int = 3) -> bool:
        """Whether a training-mode call with an input of `ndim` axes takes
        the fused kernels."""
        return (self.fused_conv and ndim == 3 and self.stride == 1
                and self.padding in ("same", "causal")
                and not self.transposed and self.batch_norm
                and self.act_fun == "Swish")

    def _norm_act(self, x):
        """The norm (BN, or a LayerNorm over the channels) and the
        activation of channels-first (B, E, T)."""
        norm = self.layers["4"]
        if self.batch_norm:
            x = norm(x)
        else:
            x = norm(x.transpose(1, 2)).transpose(1, 2)
        return get_act(self.act_fun)(x)

    def forward(self, x, state=None, return_state: bool = False):
        """With `return_state` (streaming, causal padding only) the
        depthwise conv runs without padding over the carried tail `state`
        (B, E, k - 1) (the last k - 1 GLU outputs before this chunk)
        followed by this chunk, and the call returns (out, the new tail):
        the causal conv of the whole sequence, chunk by chunk
        (conformer.py:290-317)."""
        if return_state:
            if self.padding != "causal" or self.transposed:
                raise ValueError("streaming needs the causal convolution "
                                 f"module, not padding {self.padding!r}"
                                 + (" transposed" if self.transposed else ""))
            x = glu(self.layers["1"](self.layers["0"](x).transpose(1, 2)),
                    dim=1)
            x = torch.cat([state.to(x.dtype), x], dim=2)
            depthwise = self.layers["3"]
            new_state = x[:, :, x.shape[2] - (depthwise.kernel_size[0] - 1):]
            x = self._norm_act(depthwise(x, pads=((0, 0),)))
            return (self.dropout(self.layers["6"](x).transpose(1, 2)),
                    new_state)
        if self.training and self.fused_eligible(x.ndim):
            rate = self.drop_rate if self.regularize else 0.0
            seed = _draw_seed(self.seed_generator) if rate > 0.0 else None
            ln, bn = self.layers["0"], self.layers["4"]
            group = self.process_group
            fn, dp = _dp_route(fused_conv_module_3d, fused_conv_module_3d_dp,
                               group)
            y, mean, var = fn(
                x, *conv_module_params(self), seed=seed, padding=self.padding,
                ln_eps=ln.eps, bn_eps=bn.eps, drop_rate=rate,
                deterministic=False, use_kernel=self.use_kernel, **dp)
            world = 1 if group is None else dist.get_world_size(group)
            bn.update_running(mean, var, x.shape[0] * x.shape[1] * world)
            return y
        x = self.layers["0"](x).transpose(1, 2)
        x = glu(self.layers["1"](x), dim=1)
        x = self._norm_act(self.layers["3"](x))
        return self.dropout(self.layers["6"](x).transpose(1, 2))


class InterCTCResModule(nn.Module):
    """logits = proj_1(x); x += proj_2(softmax(logits))."""

    def __init__(self, dim_model: int, vocab_size: int):
        super().__init__()
        self.proj_1 = Linear(dim_model, vocab_size)
        self.proj_2 = Linear(vocab_size, dim_model)

    def forward(self, x):
        logits = self.proj_1(x)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return x + self.proj_2(probs), logits


class FusionModule(nn.Module):
    """concat(audio, video) -> Linear(4 f) -> swish -> Linear(f)."""

    def __init__(self, a_dim_model=360, v_dim_model=360, f_dim_model=360,
                 ff_ratio=4):
        super().__init__()
        self.layers = _indexed({
            0: Linear(a_dim_model + v_dim_model, ff_ratio * f_dim_model),
            2: Linear(ff_ratio * f_dim_model, f_dim_model)})

    def forward(self, audio, video):
        x = self.layers["0"](torch.cat([audio, video], dim=-1))
        return self.layers["2"](swish(x))


class ConformerBlock(nn.Module):
    """x += ff1/2; x += MHSA(LN(x)); x = res(x) + conv(x); x += ff2/2; LN
    (conformer.py:358-451). A strided block downsamples in its conv module;
    its residual is a stride-2 max pool (same dim) or a strided pointwise
    conv (new dim). A `transposed` block upsamples instead: its residual is
    a nearest-neighbour repeat (same dim) or a strided pointwise
    ConvTranspose (new dim). `act_fun`, `inner_dropout` and `batch_norm`
    go to the modules; `block_norm=False` leaves the last LayerNorm out."""

    def __init__(self, dim_model: int, dim_expand: int, ff_ratio: int,
                 att_params: dict, conv_stride: int = 1, kernel_size: int = 15,
                 conv_padding: str = "same", drop_rate: float = 0.1,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None,
                 inner_dropout: bool = True, act_fun: str = "Swish",
                 batch_norm: bool = True, block_norm: bool = True,
                 transposed: bool = False):
        super().__init__()
        self.stride = conv_stride
        self.transposed = transposed
        ff = dict(act_fun=act_fun, inner_dropout=inner_dropout)
        self.ff_module1 = FeedForwardModule(dim_model, dim_model * ff_ratio,
                                            drop_rate, fused_ffn, **ff)
        self.self_att_module = AttentionModule(dim_model, att_params,
                                               drop_rate, fused_att,
                                               residual=False)
        self.conv_module = ConvolutionModule(
            dim_model, dim_expand, conv_stride, kernel_size, conv_padding,
            drop_rate, fused_conv, act_fun=act_fun, batch_norm=batch_norm,
            transposed=transposed)
        self.conv_res = None
        if dim_model != dim_expand:
            self.conv_res = (
                ConvTranspose(dim_model, dim_expand, 1, ndim=1,
                              stride=conv_stride,
                              output_padding=max(conv_stride - 1, 0))
                if transposed else
                Conv(dim_model, dim_expand, 1, ndim=1, stride=conv_stride))
        self.ff_module2 = FeedForwardModule(dim_expand, dim_expand * ff_ratio,
                                            drop_rate, fused_ffn, **ff)
        self.norm = LayerNorm(dim_expand, 1e-6) if block_norm else None

    def forward(self, x, mask=None, lengths=None, state=None,
                return_state: bool = False):
        """With `return_state` (streaming) the block takes and returns its
        carried state {"att": {"K", "V"}, "conv": tail}
        (conformer.py:386-451)."""
        x = x + 0.5 * self.ff_module1(x)
        if return_state:
            att_out, att_state = self.self_att_module(
                x, mask=mask, hidden=state["att"], return_hidden=True)
            x = x + att_out
            conv_out, conv_state = self.conv_module(
                x, state=state["conv"], return_state=True)
        else:
            x = x + self.self_att_module(x, mask=mask, lengths=lengths)
            conv_out = self.conv_module(x)
        if self.conv_res is not None:
            res = self.conv_res(x.transpose(1, 2)).transpose(1, 2)
        elif self.transposed:
            res = upsample_nearest(x, self.stride, axis=1)
        else:
            res = x[:, ::self.stride]
        x = res + conv_out
        x = x + 0.5 * self.ff_module2(x)
        if self.norm is not None:
            x = self.norm(x)
        if return_state:
            return x, {"att": att_state, "conv": conv_state}
        return x


class ConformerInterCTC(nn.Module):
    """Multi-stage conformer stack with InterCTC taps (conformer.py:483).

    The blocks of the JAX `_block_plan` written out flat: stage s has
    num_blocks[s] blocks at dims[s]; the last block of every stage but the
    last strides by conv_stride into dims[s+1]. Block i (0-based) carries an
    InterCTC module when i+1 is in interctc_blocks; outputs are keyed
    "{loss_prefix}_{i}". Masks and lengths are re-strided after each strided
    block. Dropout opens the stack (conformer.py:591). `batch_norm` goes to
    every block's convolution module.

    `remat` rematerializes in training the blocks that the JAX package
    rematerializes (conformer.py:594-611): those of the runs of
    `block_plan` with more than one block (consecutive blocks of one
    configuration, stride 1, no InterCTC tap); each such block keeps no
    activation for the backward, which recomputes them
    (`models/remat.py`). The parameters are the same with remat on and
    off."""

    def __init__(self, dim_model: Union[int, Sequence[int]],
                 num_blocks: Union[int, Sequence[int]],
                 interctc_blocks: Sequence[int], vocab_size: int,
                 att_params, loss_prefix: str = "ctc", kernel_size: int = 15,
                 ff_ratio: int = 4, conv_stride: int = 2,
                 conv_padding: str = "same", drop_rate: float = 0.1,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, batch_norm: bool = True,
                 remat: bool = False):
        super().__init__()
        self.dropout = Dropout(drop_rate)
        dims = [dim_model] if isinstance(dim_model, int) else list(dim_model)
        nblocks = [num_blocks] if isinstance(num_blocks, int) else list(num_blocks)
        self.loss_prefix = loss_prefix
        self.interctc_at: List[int] = []
        self.kernel_size = kernel_size
        self.block_stage: List[int] = []
        self.remat = remat
        self._configs: List[Dict] = []
        blocks, inter = [], []
        i = 0
        for stage in range(len(nblocks)):
            att = (att_params[stage] if isinstance(att_params, (list, tuple))
                   else att_params)
            for block_id in range(nblocks[stage]):
                down = block_id == nblocks[stage] - 1 and stage < len(nblocks) - 1
                dim_out = dims[stage + 1] if down else dims[stage]
                config = dict(dim_model=dims[stage], dim_expand=dim_out,
                              ff_ratio=ff_ratio, att_params=att,
                              drop_rate=drop_rate,
                              conv_stride=conv_stride if down else 1,
                              kernel_size=kernel_size,
                              conv_padding=conv_padding,
                              batch_norm=batch_norm)
                self._configs.append(config)
                blocks.append(ConformerBlock(
                    dims[stage], dim_out, ff_ratio, att,
                    conv_stride=config["conv_stride"],
                    kernel_size=kernel_size, conv_padding=conv_padding,
                    drop_rate=drop_rate, fused_att=fused_att,
                    fused_conv=fused_conv, fused_ffn=fused_ffn,
                    batch_norm=batch_norm))
                self.block_stage.append(stage)
                if i + 1 in set(interctc_blocks):
                    self.interctc_at.append(i)
                    inter.append(InterCTCResModule(dim_out, vocab_size))
                i += 1
        self.conformer_blocks = nn.ModuleList(blocks)
        self.interctc_modules = nn.ModuleList(inter)
        self.remat_blocks = frozenset(
            j for run in self.block_plan() if len(run) > 1 for j in run)

    def block_plan(self) -> List[List[int]]:
        """The blocks' indices grouped as the JAX `_block_plan` groups them
        (conformer.py:521-573): consecutive blocks of stride 1, without an
        InterCTC tap and of one configuration form a run; every other
        block is a run of its own."""
        runs: List[List[int]] = []
        current: List[int] = []
        for i, config in enumerate(self._configs):
            if config["conv_stride"] == 1 and i not in self.interctc_at:
                if current and self._configs[current[0]] == config:
                    current.append(i)
                    continue
                if current:
                    runs.append(current)
                current = [i]
            else:
                if current:
                    runs.append(current)
                    current = []
                runs.append([i])
        if current:
            runs.append(current)
        return runs

    def forward(self, x, lengths=None, mask=None):
        interctc_outputs = {}
        x = self.dropout(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, block in enumerate(self.conformer_blocks):
            if remat and i in self.remat_blocks:
                x = remat_call(block, x, mask=mask, lengths=lengths)
            else:
                x = block(x, mask=mask, lengths=lengths)
            logits = None
            if i in self.interctc_at:
                x, logits = self.interctc_modules[self.interctc_at.index(i)](x)
            if block.stride > 1:
                mask = downsample_mask(mask, block.stride)
                if lengths is not None:
                    lengths = strided_lengths(lengths, block.stride)
            if logits is not None:
                interctc_outputs[f"{self.loss_prefix}_{i}"] = [logits, lengths]
        return x, lengths, interctc_outputs

    def stream_plan(self) -> List[Dict]:
        """One entry per block (the port has no scanned runs): stage_id,
        dim_model, dim_expand, kernel_size, stride (conformer.py:575-585);
        a streaming transcriber sizes each block's carried state from it."""
        return [dict(stage_id=stage, dim_model=b.ff_module1.layers["1"]
                     .weight.shape[1],
                     dim_expand=b.ff_module2.layers["1"].weight.shape[1],
                     kernel_size=self.kernel_size, stride=b.stride)
                for stage, b in zip(self.block_stage, self.conformer_blocks)]

    def stream_forward(self, x, masks, states):
        """One chunk with carried state (eval, causal configurations;
        conformer.py:633-674): `masks` per stage (B, 1, c_s, L_s + c_s),
        `states` one {"att": {"K", "V"}, "conv": tail} per block. Returns
        (x, the blocks' new states, interctc outputs with lengths None); the
        caller trims the returned key/value caches back to their sizes."""
        interctc_outputs = {}
        new_states = []
        x = self.dropout(x)
        for i, block in enumerate(self.conformer_blocks):
            x, st = block(x, mask=masks[self.block_stage[i]],
                          state=states[i], return_state=True)
            new_states.append(st)
            if i in self.interctc_at:
                x, logits = self.interctc_modules[self.interctc_at.index(i)](x)
                interctc_outputs[f"{self.loss_prefix}_{i}"] = [logits, None]
        return x, new_states, interctc_outputs


class ConvNeuralNetwork(nn.Module):
    """Conv -> norm -> act -> dropout per layer, channels first
    (conformer.py:728-778); each layer updates lengths by (len-1)//2+1 (the
    reference hardcodes stride-2 updates). `kernel_size` and `strides` are
    one value or a list per layer; `norm` names a norm_dict entry (None:
    none); a conv that feeds a BatchNorm has its bias detached in
    training. `weight_init` / `bias_init` are the convs' inits. Layer i's
    conv is `layers.{i}.0` and its norm `layers.{i}.1`."""

    def __init__(self, in_ch: int, dim_layers, kernel_size,
                 ndim: int = 2, strides=1, norm=None, act_fun="ReLU",
                 drop_rate: float = 0.0, padding="same",
                 weight_init: str = "default", bias_init: str = "default"):
        super().__init__()
        dims = [dim_layers] if isinstance(dim_layers, int) else list(dim_layers)
        layers, prev = [], in_ch
        for i, dim in enumerate(dims):
            _, mod = _norm_layer(norm, dim)
            conv = Conv(prev, dim, _per_layer(kernel_size, i), ndim=ndim,
                        stride=_per_layer(strides, i), padding=padding,
                        bias_stop_gradient=isinstance(mod, BatchNorm),
                        weight_init=weight_init, bias_init=bias_init)
            layers.append(nn.ModuleList([conv] + ([mod] if mod else [])))
            prev = dim
        self.layers = nn.ModuleList(layers)
        self.act = get_act(act_fun)
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else None

    def forward(self, x, lengths=None):
        for layer in self.layers:
            x = layer[0](x)
            if len(layer) > 1:
                x = _apply_norm(layer[1], x, channels_last=False)
            x = self.act(x)
            if self.dropout is not None:
                x = self.dropout(x)
            if lengths is not None:
                lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
        return x if lengths is None else (x, lengths)


def _norm_layer(norm, dim: int):
    """(JAX child name prefix, module) of a norm_dict name (or class) for
    `dim` channels; the prefix is the JAX class's, which names it."""
    cls = norm_dict[norm] if isinstance(norm, str) or norm is None else norm
    if cls is None:
        return None, None
    return cls.__name__, cls(dim)


def _apply_norm(norm: nn.Module, x, channels_last: bool):
    """LayerNorm normalises the channel axis; the other norms take channels
    first."""
    if isinstance(norm, LayerNorm) != channels_last:
        return norm(x.movedim(-1 if channels_last else 1,
                              1 if channels_last else -1)).movedim(
            1 if channels_last else -1, -1 if channels_last else 1)
    return norm(x)


def _per_layer(value, i: int):
    return value[i] if isinstance(value, list) else value


class MultiLayerPerceptron(nn.Module):
    """Linear -> norm -> act -> dropout per layer (conformer.py:677-694),
    over the last axis of (B, ..., D). `norm` names a norm_dict entry
    (GroupNorm with its default 32 groups)."""

    def __init__(self, dim_input: int, dim_layers: Sequence[int],
                 act_fun="ReLU", norm=None, drop_rate: float = 0.0):
        super().__init__()
        self.act = get_act(act_fun)
        self.names = []
        prev = dim_input
        for i, dim in enumerate(dim_layers):
            setattr(self, f"linear_{i}", Linear(prev, dim))
            prefix, mod = _norm_layer(norm, dim)
            norm_name = f"{prefix}_{i}" if mod is not None else None
            if mod is not None:
                setattr(self, norm_name, mod)
            drop = f"Dropout_{i}" if drop_rate > 0 else None
            if drop:
                setattr(self, drop, Dropout(drop_rate))
            self.names.append((f"linear_{i}", norm_name, drop))
            prev = dim

    def forward(self, x):
        for lin, norm, drop in self.names:
            x = getattr(self, lin)(x)
            if norm:
                x = _apply_norm(getattr(self, norm), x, channels_last=True)
            x = self.act(x)
            if drop:
                x = getattr(self, drop)(x)
        return x


class InceptionModule(nn.Module):
    """GoogLeNet Inception module, channels first (conformer.py:697-725):
    four branches concatenated on the channels in this order: 1x1 (c0);
    1x1 (c1) -> k0 (c2); 1x1 (c3) -> k1 (c4); 3-wide stride-1 max pool
    ("same", -inf pads) -> 1x1 (c5); every conv bias-free with
    torch-default init, followed by BN and ReLU."""

    _BRANCHES = (("branch0", None, 0), ("branch1a", None, 1),
                 ("branch1b", 0, 2), ("branch2a", None, 3),
                 ("branch2b", 1, 4), ("branch3", None, 5))

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 kernel_sizes: Sequence[int] = (3, 5), ndim: int = 2):
        super().__init__()
        self.ndim = ndim
        c = list(out_channels)
        ins = {"branch0": in_channels, "branch1a": in_channels,
               "branch1b": c[1], "branch2a": in_channels, "branch2b": c[3],
               "branch3": in_channels}
        for name, k_idx, c_idx in self._BRANCHES:
            k = 1 if k_idx is None else kernel_sizes[k_idx]
            setattr(self, name, Conv(ins[name], c[c_idx], k, ndim=ndim,
                                     bias=False, weight_init="default"))
            setattr(self, name + "_bn", BatchNorm(c[c_idx]))

    def _cbr(self, name, x):
        return torch.relu(getattr(self, name + "_bn")(getattr(self, name)(x)))

    def forward(self, x):
        b0 = self._cbr("branch0", x)
        b1 = self._cbr("branch1b", self._cbr("branch1a", x))
        b2 = self._cbr("branch2b", self._cbr("branch2a", x))
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[self.ndim - 1]
        b3 = pool(F.pad(x, (1, 1) * self.ndim, value=float("-inf")), 3, 1)
        b3 = self._cbr("branch3", b3)
        return torch.cat([b0, b1, b2, b3], dim=1)


class ConvTransposeNeuralNetwork(nn.Module):
    """ConvTranspose -> norm -> act -> dropout per layer, channels first
    (conformer.py:781-820); `kernel_size`, `strides`, `padding` and
    `output_padding` are one value or a list per layer. Lengths, when
    given, come back unchanged."""

    def __init__(self, in_ch: int, dim_layers, kernel_size, ndim: int = 2,
                 strides=1, padding=0, output_padding=0, norm=None,
                 act_fun="ReLU", drop_rate: float = 0.0):
        super().__init__()
        dims = [dim_layers] if isinstance(dim_layers, int) else list(dim_layers)
        self.act = get_act(act_fun)
        self.names = []
        prev = in_ch
        for i, dim in enumerate(dims):
            setattr(self, f"convt_{i}", ConvTranspose(
                prev, dim, _per_layer(kernel_size, i), ndim=ndim,
                stride=_per_layer(strides, i), padding=_per_layer(padding, i),
                output_padding=_per_layer(output_padding, i)))
            prefix, mod = _norm_layer(norm, dim)
            norm_name = f"{prefix}_{i}" if mod is not None else None
            if mod is not None:
                setattr(self, norm_name, mod)
            drop = f"Dropout_{i}" if drop_rate > 0 else None
            if drop:
                setattr(self, drop, Dropout(drop_rate))
            self.names.append((f"convt_{i}", norm_name, drop))
            prev = dim

    def forward(self, x, lengths=None):
        for conv, norm, drop in self.names:
            x = getattr(self, conv)(x)
            if norm:
                x = _apply_norm(getattr(self, norm), x, channels_last=False)
            x = self.act(x)
            if drop:
                x = getattr(self, drop)(x)
        return x if lengths is None else (x, lengths)
