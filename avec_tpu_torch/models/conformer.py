"""Conformer blocks and the InterCTC conformer stack (port of
avec_tpu/models/conformer.py), eval and training.

Sequences are (B, T, D); masks boolean (B, 1, 1, T); lengths int (B,).
Parameter names follow the reference state_dict: ff_module{1,2}.layers.{0,1,4},
self_att_module.{norm,attention}, conv_module.layers.{0,1,3,4,6}, conv_res,
norm; conformer_blocks.{i} and interctc_modules.{k} in the stack.

Training mode (`nn.Module.train()`): the feed-forward module runs as one
fused kernel (`ops/ffn.py`), the attention module as one fused kernel per
direction (`ops/attention_module.py`) where `fused_att` is on, and the
convolution module as two fused kernels per direction
(`ops/conv_module.py`) where `fused_conv` is on; dropout follows the
attention, convolution and feed-forward modules and opens the stack, the
convolution module's BatchNorm uses batch statistics and the depthwise conv's
bias is detached.
"""

import os
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from avec_tpu_torch.ops.activations import get_act, glu, swish
from avec_tpu_torch.ops.attention import (RelPos1dMultiHeadAttention,
                                          make_attention)
from avec_tpu_torch.ops.attention_module import fused_attention_module_3d
from avec_tpu_torch.ops.conv_module import (conv_module_params,
                                            fused_conv_module_3d)
from avec_tpu_torch.ops.ffn import fused_ffn_3d
from avec_tpu_torch.ops.layers import (BatchNorm, Conv, Dropout, LayerNorm,
                                       Linear)
from avec_tpu_torch.ops.masks import downsample_mask, strided_lengths


def _indexed(mods: Dict[int, nn.Module]) -> nn.ModuleDict:
    """A ModuleDict keyed like the reference's nn.Sequential indices."""
    return nn.ModuleDict({str(i): m for i, m in mods.items()})


class FeedForwardModule(nn.Module):
    """Pre-norm FFN: LN(1e-6) -> Linear(d_ffn) -> swish -> drop -> Linear(d)
    -> drop (conformer.py:86).

    In training mode a (B, T, d) input goes through the fused kernel of
    `ops/ffn.py` (the JAX gate of conformer.py:103-107: training, pre-norm,
    3-d input, Swish), with a 31-bit dropout seed drawn from
    `seed_generator`, a CPU `torch.Generator` set by the owning model. Eval
    runs the unfused layers. `use_kernel=False` routes the fused path through
    its plain version; `regularize=False` turns dropout off."""

    def __init__(self, dim_model: int, dim_ffn: int, drop_rate: float = 0.1):
        super().__init__()
        self.layers = _indexed({0: LayerNorm(dim_model, 1e-6),
                                1: Linear(dim_model, dim_ffn),
                                4: Linear(dim_ffn, dim_model)})
        self.dropout = Dropout(drop_rate)
        self.drop_rate = drop_rate
        self.use_kernel = True
        self.regularize = True
        self.seed_generator = None
        self.training = False

    def forward(self, x):
        norm, lin1, lin2 = (self.layers[k] for k in ("0", "1", "4"))
        if self.training and x.ndim == 3:
            rate = self.drop_rate if self.regularize else 0.0
            seed = _draw_seed(self.seed_generator) if rate > 0.0 else None
            return fused_ffn_3d(x, norm.weight, norm.bias, lin1.weight,
                                lin1.bias, lin2.weight, lin2.bias, seed=seed,
                                epsilon=norm.eps, drop_rate=rate,
                                deterministic=False,
                                use_kernel=self.use_kernel)
        x = self.dropout(swish(lin1(norm(x))))
        return self.dropout(lin2(x))


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


class AttentionModule(nn.Module):
    """Pre-norm attention + dropout (no residual inside the conformer
    block).

    With `fused_att` (None: the environment variable AVEC_TPU_FUSED_ATT) the
    module runs as one fused kernel per direction (`ops/attention_module.py`)
    where the JAX gate of conformer.py:153-174 lets it: training mode, a 3-d
    input, `RelPos1dMultiHeadAttention` itself (not the patch subclass) with
    `use_flash` off, and no mask or a key-padding mask (B, 1, 1, T). The
    lengths are the `lengths` argument, else the mask's row sums; the 31-bit
    dropout seed comes from `seed_generator`, as in `FeedForwardModule`.
    Eval always runs the unfused layers. `use_kernel=False` routes the fused
    path through its plain version; `regularize=False` turns its dropout
    off."""

    def __init__(self, dim_model: int, att_params: dict,
                 drop_rate: float = 0.1, fused_att: Optional[bool] = None):
        super().__init__()
        self.norm = LayerNorm(dim_model, 1e-6)
        self.attention = make_attention(dim_model, att_params)
        self.dropout = Dropout(drop_rate)
        self.drop_rate = drop_rate
        self.fused_att = (_fused_att_enabled() if fused_att is None
                          else bool(fused_att))
        self.use_kernel = True
        self.regularize = True
        self.seed_generator = None
        self.training = False

    def fused_eligible(self, ndim: int = 3, mask=None) -> bool:
        """Whether a training-mode call with an input of `ndim` axes and this
        mask takes the fused kernels."""
        att = self.attention
        return (self.fused_att and ndim == 3
                and type(att) is RelPos1dMultiHeadAttention
                and not att.use_flash
                and (mask is None or (mask.ndim == 4 and mask.shape[2] == 1))
                and att.dim_model % att.num_heads == 0
                and att.dim_model % 2 == 0)

    def forward(self, x, mask=None, lengths=None):
        if self.training and self.fused_eligible(x.ndim, mask):
            att = self.attention
            rate = self.drop_rate if self.regularize else 0.0
            seed = _draw_seed(self.seed_generator) if rate > 0.0 else None
            if lengths is None and mask is not None:
                lengths = mask[:, 0, 0, :].sum(dim=-1).to(torch.int32)
            return fused_attention_module_3d(
                x, self.norm.weight, self.norm.bias,
                att.query_layer.weight, att.query_layer.bias,
                att.key_layer.weight, att.key_layer.bias,
                att.value_layer.weight, att.value_layer.bias,
                att.pos_layer.weight, att.pos_layer.bias,
                att.output_layer.weight, att.output_layer.bias,
                num_heads=att.num_heads, lengths=lengths, seed=seed,
                drop_rate=rate, deterministic=False, residual=False,
                ln_eps=self.norm.eps, use_kernel=self.use_kernel)
        return self.dropout(self.attention(self.norm(x), mask=mask,
                                           lengths=lengths))


class ConvolutionModule(nn.Module):
    """LN -> pointwise 2E -> GLU -> depthwise k (stride) -> BN -> swish
    -> pointwise E -> drop; channels-first inside, (B, T, D) at the boundary.
    The depthwise conv feeds the BN, so its bias is detached in training.

    With `fused_conv` (None: the environment variable AVEC_TPU_FUSED_CONV)
    the module runs as the fused kernels of `ops/conv_module.py` where the
    JAX gate of conformer.py:248-253 lets it: training mode, stride 1,
    padding "same" or "causal", a 3-d input (BatchNorm and swish are the
    port module's only choice). The batch statistics the kernels return move
    the BatchNorm's running statistics; the 31-bit dropout seed comes from
    `seed_generator`, as in `FeedForwardModule`. Eval always runs the unfused
    layers. `use_kernel=False` routes the fused path through its plain
    stages; `regularize=False` turns its dropout off."""

    def __init__(self, dim_model: int, dim_expand: int, stride: int = 1,
                 kernel_size: int = 15, padding: str = "same",
                 drop_rate: float = 0.1, fused_conv: Optional[bool] = None):
        super().__init__()
        self.layers = _indexed({
            0: LayerNorm(dim_model, 1e-6),
            1: Conv(dim_model, 2 * dim_expand, 1, ndim=1),
            3: Conv(dim_expand, dim_expand, kernel_size, ndim=1, stride=stride,
                    padding=padding, groups=dim_expand,
                    bias_stop_gradient=True),
            4: BatchNorm(dim_expand),
            6: Conv(dim_expand, dim_expand, 1, ndim=1)})
        self.dropout = Dropout(drop_rate)
        self.drop_rate = drop_rate
        self.stride = stride
        self.padding = padding
        self.fused_conv = (_fused_conv_enabled() if fused_conv is None
                           else bool(fused_conv))
        self.use_kernel = True
        self.regularize = True
        self.seed_generator = None
        self.training = False

    def fused_eligible(self, ndim: int = 3) -> bool:
        """Whether a training-mode call with an input of `ndim` axes takes
        the fused kernels."""
        return (self.fused_conv and ndim == 3 and self.stride == 1
                and self.padding in ("same", "causal"))

    def forward(self, x):
        if self.training and self.fused_eligible(x.ndim):
            rate = self.drop_rate if self.regularize else 0.0
            seed = _draw_seed(self.seed_generator) if rate > 0.0 else None
            ln, bn = self.layers["0"], self.layers["4"]
            y, mean, var = fused_conv_module_3d(
                x, *conv_module_params(self), seed=seed, padding=self.padding,
                ln_eps=ln.eps, bn_eps=bn.eps, drop_rate=rate,
                deterministic=False, use_kernel=self.use_kernel)
            bn.update_running(mean, var, x.shape[0] * x.shape[1])
            return y
        x = self.layers["0"](x).transpose(1, 2)
        x = glu(self.layers["1"](x), dim=1)
        x = swish(self.layers["4"](self.layers["3"](x)))
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
    """x += ff1/2; x += MHSA(LN(x)); x = res(x) + conv(x); x += ff2/2; LN.
    A strided block downsamples in its conv module; its residual is a
    stride-2 max pool (same dim) or a strided pointwise conv (new dim)."""

    def __init__(self, dim_model: int, dim_expand: int, ff_ratio: int,
                 att_params: dict, conv_stride: int = 1, kernel_size: int = 15,
                 conv_padding: str = "same", drop_rate: float = 0.1,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None):
        super().__init__()
        self.stride = conv_stride
        self.ff_module1 = FeedForwardModule(dim_model, dim_model * ff_ratio,
                                            drop_rate)
        self.self_att_module = AttentionModule(dim_model, att_params,
                                               drop_rate, fused_att)
        self.conv_module = ConvolutionModule(dim_model, dim_expand, conv_stride,
                                             kernel_size, conv_padding,
                                             drop_rate, fused_conv)
        self.conv_res = (Conv(dim_model, dim_expand, 1, ndim=1,
                              stride=conv_stride)
                         if dim_model != dim_expand else None)
        self.ff_module2 = FeedForwardModule(dim_expand, dim_expand * ff_ratio,
                                            drop_rate)
        self.norm = LayerNorm(dim_expand, 1e-6)

    def forward(self, x, mask=None, lengths=None):
        x = x + 0.5 * self.ff_module1(x)
        x = x + self.self_att_module(x, mask=mask, lengths=lengths)
        conv_out = self.conv_module(x)
        if self.conv_res is not None:
            res = self.conv_res(x.transpose(1, 2)).transpose(1, 2)
        else:
            res = x[:, ::self.stride]
        x = res + conv_out
        x = x + 0.5 * self.ff_module2(x)
        return self.norm(x)


class ConformerInterCTC(nn.Module):
    """Multi-stage conformer stack with InterCTC taps (conformer.py:483).

    The block plan of the JAX `_block_plan` written out flat: stage s has
    num_blocks[s] blocks at dims[s]; the last block of every stage but the
    last strides by conv_stride into dims[s+1]. Block i (0-based) carries an
    InterCTC module when i+1 is in interctc_blocks; outputs are keyed
    "{loss_prefix}_{i}". Masks and lengths are re-strided after each strided
    block. Dropout opens the stack (conformer.py:591)."""

    def __init__(self, dim_model: Union[int, Sequence[int]],
                 num_blocks: Union[int, Sequence[int]],
                 interctc_blocks: Sequence[int], vocab_size: int,
                 att_params, loss_prefix: str = "ctc", kernel_size: int = 15,
                 ff_ratio: int = 4, conv_stride: int = 2,
                 conv_padding: str = "same", drop_rate: float = 0.1,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None):
        super().__init__()
        self.dropout = Dropout(drop_rate)
        dims = [dim_model] if isinstance(dim_model, int) else list(dim_model)
        nblocks = [num_blocks] if isinstance(num_blocks, int) else list(num_blocks)
        self.loss_prefix = loss_prefix
        self.interctc_at: List[int] = []
        blocks, inter = [], []
        i = 0
        for stage in range(len(nblocks)):
            att = (att_params[stage] if isinstance(att_params, (list, tuple))
                   else att_params)
            for block_id in range(nblocks[stage]):
                down = block_id == nblocks[stage] - 1 and stage < len(nblocks) - 1
                dim_out = dims[stage + 1] if down else dims[stage]
                blocks.append(ConformerBlock(
                    dims[stage], dim_out, ff_ratio, att,
                    conv_stride=conv_stride if down else 1,
                    kernel_size=kernel_size, conv_padding=conv_padding,
                    drop_rate=drop_rate, fused_att=fused_att,
                    fused_conv=fused_conv))
                if i + 1 in set(interctc_blocks):
                    self.interctc_at.append(i)
                    inter.append(InterCTCResModule(dim_out, vocab_size))
                i += 1
        self.conformer_blocks = nn.ModuleList(blocks)
        self.interctc_modules = nn.ModuleList(inter)

    def forward(self, x, lengths=None, mask=None):
        interctc_outputs = {}
        x = self.dropout(x)
        for i, block in enumerate(self.conformer_blocks):
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


class ConvNeuralNetwork(nn.Module):
    """Conv -> BN -> act stack, channels-first; each layer updates lengths
    by (len-1)//2+1 (the reference hardcodes stride-2 updates). Each conv
    feeds a BN, so its bias is detached in training."""

    def __init__(self, in_ch: int, dim_layers: Sequence[int], kernel_size,
                 ndim: int = 2, strides=1, act_fun="Swish",
                 padding="same"):
        super().__init__()
        layers, prev = [], in_ch
        for dim in dim_layers:
            layers.append(nn.ModuleList([
                Conv(prev, dim, kernel_size, ndim=ndim, stride=strides,
                     padding=padding, bias_stop_gradient=True),
                BatchNorm(dim)]))
            prev = dim
        self.layers = nn.ModuleList(layers)
        self.act = get_act(act_fun)

    def forward(self, x, lengths=None):
        for conv, bn in self.layers:
            x = self.act(bn(conv(x)))
            if lengths is not None:
                lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
        return x if lengths is None else (x, lengths)
