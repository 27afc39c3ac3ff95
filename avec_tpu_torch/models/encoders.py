"""Efficient Conformer encoders (port of avec_tpu/models/encoders.py), eval
and training.

Audio (B, Ta) raw 16 kHz waveform; video (B, Tv, 88, 88, 1) channels-last.
Audio runs fbank -> conv stem -> 3-stage conformer [180, 256, 360]; video
runs the Conv3d stem -> per-frame ResNet18 -> 2-stage conformer [256, 360];
the AV encoder fuses both at 360-d and runs 5 more conformer blocks.

Training mode (`nn.Module.train()`, the JAX `training=True`): SpecAugment
after the fbank, batch statistics in every BatchNorm (audio stem, video stem,
ResNet, convolution modules), dropout in the conformer stacks, and with
`fused_ffn`, `fused_att` and `fused_conv` the fused feed-forward, attention
and convolution kernels. `remat` rematerializes the conformer stacks' uniform
block runs in training (`ConformerInterCTC`).
The video stem trains in mode "2d" (plain PyTorch) or "pallas" (the BN + ReLU
+ pool kernel applied with batch statistics). In data-parallel training every
BatchNorm takes the statistics of the global batch (the model's
`set_data_parallel`).
"""

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from avec_tpu_torch.models.conformer import (ConformerInterCTC,
                                             ConvNeuralNetwork, FusionModule)
from avec_tpu_torch.models.resnet import ResNet
from avec_tpu_torch.ops.audio import AudioPreprocessing, SpecAugment
from avec_tpu_torch.ops.layers import BatchNorm, Conv, Linear
from avec_tpu_torch.ops.masks import make_mask
from avec_tpu_torch.ops.stem import (fused_stem_eval, fused_stem_train,
                                     stem_conv)


def _stem_mode() -> str:
    """Video-stem implementation from AVEC_TPU_STEM ("2d" default, or
    "pallas": the hand-written BN+ReLU+pool kernel)."""
    return os.environ.get("AVEC_TPU_STEM", "2d")


class FusedVideoStem(nn.Module):
    """Conv3d 1->64 k(5,7,7) s(1,2,2) + BN + ReLU + 3x3/2 max pool
    (encoders.py:79). Returns frames flattened: (B*T, 22, 22, 64).

    mode "2d" is plain PyTorch, in eval and in training (batch statistics,
    running update, detached conv bias: encoders.py:135-152); mode "pallas"
    runs the BN+ReLU+pool kernel (`ops/stem.py`), or its plain version when
    `use_kernel` is False: in eval with the running statistics, in training
    with the batch's (`fused_stem_train`), moving the running statistics
    towards the batch mean and the unbiased batch variance
    (encoders.py:183-191). In data-parallel training mode "2d" syncs its
    BatchNorm over the ranks; mode "pallas" has single-device statistics, as
    the JAX kernel does (pallas_stem.py:38-42), and the model's
    `set_data_parallel` refuses it for more than one rank. `momentum` (flax's
    convention: the running statistics keep that share) and `epsilon` are
    the BatchNorm's (encoders.py:103-104)."""

    def __init__(self, mode: str = "2d", momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        if mode not in ("2d", "pallas"):
            raise ValueError(f"stem mode {mode!r}: the port has '2d' and "
                             "'pallas'")
        self.mode = mode
        self.use_kernel = True
        self.layers = nn.ModuleList([nn.ModuleList([
            Conv(1, 64, (5, 7, 7), ndim=3, stride=(1, 2, 2)),
            BatchNorm(64, eps=epsilon, momentum=1.0 - momentum)])])
        self.training = False

    def forward(self, x):
        if tuple(x.shape[2:]) != (88, 88, 1):
            raise ValueError(f"video frames must be (88, 88, 1), got "
                             f"{tuple(x.shape[2:])}")
        conv, bn = self.layers[0]
        if self.mode == "pallas":
            if self.training:
                pooled, mean, var = fused_stem_train(
                    x, conv.weight, conv.bias, bn.weight, bn.bias, bn.eps,
                    use_kernel=self.use_kernel)
                bn.update_running(mean, var, pooled.shape[0] * 44 * 44)
                return pooled
            return fused_stem_eval(x, conv.weight, conv.bias, bn.weight,
                                   bn.bias, bn.running_mean, bn.running_var,
                                   bn.eps, use_kernel=self.use_kernel)
        bias = conv.bias.detach() if self.training else conv.bias
        y = bn(stem_conv(x, conv.weight, bias).permute(0, 3, 1, 2))
        # relu commutes with max: pooling first is exact and 4x cheaper.
        y = torch.relu(F.max_pool2d(y, 3, 2, padding=1))
        return y.permute(0, 2, 3, 1)


def _att_params_audio(att_type: str, num_heads: int, use_flash: bool,
                      causal: bool = False) -> List[Dict]:
    """Per-stage attention specs (encoders.py:196-226). Patch attention
    carries no use_flash, so flash runs only in the "regular" stages;
    "grouped" is the grouped Transformer-XL attention with groups of 3
    frames in stage 1 and 1 in stages 2-3."""
    regular = {"class": "RelPos1dMultiHeadAttention",
               "params": {"num_heads": num_heads, "use_flash": use_flash}}
    if att_type == "regular":
        return [regular, regular, regular]
    if att_type == "grouped":
        return [{"class": "GroupedRelPosMultiHeadSelfAttention",
                 "params": {"num_heads": num_heads, "group_size": g,
                            "causal": causal}} for g in (3, 1, 1)]
    if att_type == "patch":
        patch = {"class": "RelPosPatch1dMultiHeadAttention",
                 "params": {"num_heads": num_heads, "patch_size": 3}}
        return [patch, regular, regular]
    raise ValueError(att_type)


class AudioEfficientConformerEncoder(nn.Module):
    """Raw audio -> features (encoders.py:229): fbank (fp32, no
    normalisation) -> conv2d stem 1->180 k3 s2 + BN + swish -> channel-major
    flatten (180*40) -> Linear 180 -> conformer [180, 256, 360].

    `causal` is the offline path of the causal variant (encoders.py:286-
    336): the stem pads causally in time and centred in frequency, every
    convolution module pads causally (`pad_lo` = k - 1), and every stage
    runs Transformer-XL attention under a causal band mask of `left_context`
    stage-1 frames, which the restriding halves per stage. The stem runs
    channels-first on (B, 1, 80, T), frequency before time, so its padding
    is ("same", "causal") where the JAX stem, time-major, has ("causal",
    "same").

    `stream_step` is the causal variant's chunked step (encoders.py:345-401,
    eval): a chunk of fbank frames through the stem and the conformer with
    carried state, the stem's 2-frame fbank tail taking the place of its
    causal time padding."""

    def __init__(self, include_head: bool = True, vocab_size: int = 256,
                 att_type: str = "patch",
                 interctc_blocks: Sequence[int] = (3, 6, 10, 13),
                 num_blocks: Sequence[int] = (5, 6, 5),
                 loss_prefix: str = "ctc", use_flash: bool = False,
                 causal: bool = False, left_context: Optional[int] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, remat: bool = False):
        super().__init__()
        n_mels, filters, dims, heads = 80, 180, [180, 256, 360], 4
        self.causal, self.left_context = causal, left_context
        self.preprocessing = AudioPreprocessing(
            sample_rate=16000, n_fft=512, win_length_ms=25, hop_length_ms=10,
            n_mels=n_mels, normalize=False)
        self.spec_augment = SpecAugment(mF=2, F=27, mT=5, pS=0.05)
        self.subsampling_module = ConvNeuralNetwork(
            1, [filters], 3, ndim=2, strides=2, norm="BatchNorm2d",
            act_fun="Swish",
            padding=("same", "causal") if causal else "same")
        self.linear = Linear(filters * (n_mels // 2), dims[0])
        if causal:
            xl = {"class": "RelPosMultiHeadSelfAttention",
                  "params": {"num_heads": heads, "causal": True}}
            att_params = [xl, xl, xl]
        else:
            att_params = _att_params_audio(att_type, heads, use_flash, causal)
        self.back_end = ConformerInterCTC(
            dims, list(num_blocks), list(interctc_blocks), vocab_size,
            att_params, loss_prefix=loss_prefix,
            conv_padding="causal" if causal else "same", fused_att=fused_att,
            fused_conv=fused_conv, fused_ffn=fused_ffn, remat=remat)
        self.head = Linear(dims[-1], vocab_size) if include_head else None

    def forward(self, x, lengths):
        x, lengths = self.preprocessing(x, lengths)       # (B, 80, T')
        x = self.spec_augment(x, lengths)                  # training only
        x, lengths = self.subsampling_module(x[:, None], lengths)
        b, c, f, t = x.shape                               # (B, 180, 40, T'')
        x = self.linear(x.permute(0, 3, 1, 2).reshape(b, t, c * f))
        if self.causal:
            mask = make_mask(t, lengths, left_context=self.left_context,
                             right_context=0)
        else:
            mask = make_mask(t, lengths)
        x, lengths, inter = self.back_end(x, lengths, mask)
        if self.head is not None:
            x = self.head(x)
        return x, lengths, inter

    def stream_state(self, batch: int, left_context: int, dtype, device):
        """Zero state for `stream_step`: the stem's fbank tail (B, 1, n_mels,
        2), then per block a key/value cache of left_context >> stage keys
        (B, L_s, dim_model) and a depthwise tail (B, dim_expand, k - 1)
        (causal_streaming.py:111-131)."""
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        n_mels = self.preprocessing.mel.shape[1]
        blocks = []
        for p in self.back_end.stream_plan():
            l_s = left_context >> p["stage_id"]
            blocks.append({"att": {"K": zeros(batch, l_s, p["dim_model"]),
                                   "V": zeros(batch, l_s, p["dim_model"])},
                           "conv": zeros(batch, p["dim_expand"],
                                         p["kernel_size"] - 1)})
        return {"stem": zeros(batch, 1, n_mels, 2), "blocks": blocks}

    def stream_step(self, x, state, masks):
        """One chunk (causal configurations, eval): x (B, n_mels, Tc) log-mel
        frames, Tc a multiple of 8; `state` as `stream_state` gives it;
        `masks` per stage (B, 1, c_s, L_s + c_s). The stem's conv runs
        without time padding over the carried tail and the chunk, which is
        the offline ("same", "causal") stem. Returns (logits or features
        (B, Tc / 8, .), interctc outputs, the new state, key/value caches
        untrimmed)."""
        if not self.causal:
            raise ValueError("stream_step needs the causal encoder")
        x = torch.cat([state["stem"].to(x.dtype), x[:, None]], dim=3)
        new_stem = x[:, :, :, x.shape[3] - 2:]
        (conv, bn), = self.subsampling_module.layers
        freq_pads = conv.pads[0]
        x = self.subsampling_module.act(bn(conv(x, pads=(freq_pads,
                                                         (0, 0)))))
        b, c, f, t = x.shape                               # (B, 180, 40, T)
        x = self.linear(x.permute(0, 3, 1, 2).reshape(b, t, c * f))
        x, blocks, inter = self.back_end.stream_forward(x, masks,
                                                        state["blocks"])
        if self.head is not None:
            x = self.head(x)
        return x, inter, {"stem": new_stem, "blocks": blocks}


class VisualEfficientConformerEncoder(nn.Module):
    """Lip video -> features (encoders.py:391): stem -> per-frame ResNet18
    (256) -> conformer [256, 360]."""

    def __init__(self, include_head: bool = True, vocab_size: int = 256,
                 interctc_blocks: Sequence[int] = (3, 6, 9),
                 num_blocks: Sequence[int] = (6, 6), loss_prefix: str = "ctc",
                 stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, remat: bool = False):
        super().__init__()
        dims = [256, 360]
        self.front_end = nn.ModuleDict({
            "0": FusedVideoStem(stem_mode or _stem_mode()),
            "3": ResNet("ResNet18", dim_output=dims[0], include_stem=False,
                        head_weight_init="default",
                        head_bias_init="default")})
        att = {"class": "RelPos1dMultiHeadAttention",
               "params": {"num_heads": 4}}
        self.back_end = ConformerInterCTC(
            dims, list(num_blocks), list(interctc_blocks), vocab_size, att,
            loss_prefix=loss_prefix, fused_att=fused_att,
            fused_conv=fused_conv, fused_ffn=fused_ffn, remat=remat)
        self.head = Linear(dims[-1], vocab_size) if include_head else None

    def forward(self, x, lengths):
        b, t = x.shape[0], x.shape[1]
        frames = self.front_end["0"](x)                    # (B*T, 22, 22, 64)
        x = self.front_end["3"](frames.permute(0, 3, 1, 2)).reshape(b, t, -1)
        x, lengths, inter = self.back_end(x, lengths, make_mask(t, lengths))
        if self.head is not None:
            x = self.head(x)
        return x, lengths, inter


class AudioVisualEfficientConformerEncoder(nn.Module):
    """Audio-visual encoder (encoders.py:482): both encoders to 360-d, video
    padded or cropped to the audio time axis, fusion MLP, 5 AV blocks."""

    def __init__(self, include_head: bool = True, vocab_size: int = 256,
                 v_interctc_blocks: Sequence[int] = (3, 6),
                 a_interctc_blocks: Sequence[int] = (8, 11),
                 f_interctc_blocks: Sequence[int] = (2,),
                 v_num_blocks: Sequence[int] = (6, 1),
                 a_num_blocks: Sequence[int] = (5, 6, 1),
                 f_num_blocks: int = 5, use_flash: bool = False,
                 stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, remat: bool = False):
        super().__init__()
        dim = 360
        self.video_encoder = VisualEfficientConformerEncoder(
            include_head=False, vocab_size=vocab_size,
            interctc_blocks=v_interctc_blocks, num_blocks=v_num_blocks,
            loss_prefix="v_ctc", stem_mode=stem_mode, fused_att=fused_att,
            fused_conv=fused_conv, fused_ffn=fused_ffn, remat=remat)
        self.audio_encoder = AudioEfficientConformerEncoder(
            include_head=False, vocab_size=vocab_size,
            interctc_blocks=a_interctc_blocks, num_blocks=a_num_blocks,
            loss_prefix="a_ctc", use_flash=use_flash, fused_att=fused_att,
            fused_conv=fused_conv, fused_ffn=fused_ffn, remat=remat)
        self.fusion_module = FusionModule(dim, dim, dim)
        att = {"class": "RelPos1dMultiHeadAttention",
               "params": {"num_heads": 4}}
        self.audio_visual_encoder = ConformerInterCTC(
            dim, f_num_blocks, list(f_interctc_blocks), vocab_size, att,
            loss_prefix="f_ctc", fused_att=fused_att, fused_conv=fused_conv,
            fused_ffn=fused_ffn, remat=remat)
        self.head = Linear(dim, vocab_size) if include_head else None

    def forward(self, video, video_len, audio, audio_len):
        v, _, v_inter = self.video_encoder(video, video_len)
        a, lengths, a_inter = self.audio_encoder(audio, audio_len)
        ta = a.shape[1]
        if v.shape[1] < ta:
            v = F.pad(v, (0, 0, 0, ta - v.shape[1]))
        v = v[:, :ta]
        x = self.fusion_module(a, v)
        x, lengths, f_inter = self.audio_visual_encoder(
            x, lengths, make_mask(ta, lengths))
        inter = {**f_inter, **v_inter, **a_inter}
        if self.head is not None:
            x = self.head(x)
        return x, lengths, inter
