"""Efficient Conformer encoders (port of avec_tpu/models/encoders.py), eval
and training.

Audio (B, Ta) raw 16 kHz waveform; video (B, Tv, 88, 88, 1) channels-last.
Audio runs fbank -> conv stem -> 3-stage conformer [180, 256, 360]; video
runs the Conv3d stem -> per-frame ResNet18 -> 2-stage conformer [256, 360];
the AV encoder fuses both at 360-d and runs 5 more conformer blocks.

Training mode (`nn.Module.train()`, the JAX `training=True`): SpecAugment
after the fbank, batch statistics in every BatchNorm (audio stem, video stem,
ResNet, convolution modules), dropout and the fused feed-forward kernels in
the conformer stacks (and, with `fused_att` and `fused_conv`, the fused
attention and convolution kernels).
The video stem trains in mode "2d" (plain PyTorch) or "pallas" (the BN + ReLU
+ pool kernel applied with batch statistics).
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
    (encoders.py:183-191)."""

    def __init__(self, mode: str = "2d"):
        super().__init__()
        if mode not in ("2d", "pallas"):
            raise ValueError(f"stem mode {mode!r}: the port has '2d' and "
                             "'pallas'")
        self.mode = mode
        self.use_kernel = True
        self.layers = nn.ModuleList([nn.ModuleList([
            Conv(1, 64, (5, 7, 7), ndim=3, stride=(1, 2, 2)),
            BatchNorm(64)])])
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


def _att_params_audio(att_type: str, num_heads: int, use_flash: bool
                      ) -> List[Dict]:
    """Per-stage attention specs (encoders.py:196). Patch attention carries
    no use_flash, so flash runs only in the "regular" stages."""
    regular = {"class": "RelPos1dMultiHeadAttention",
               "params": {"num_heads": num_heads, "use_flash": use_flash}}
    if att_type == "regular":
        return [regular, regular, regular]
    if att_type == "patch":
        patch = {"class": "RelPosPatch1dMultiHeadAttention",
                 "params": {"num_heads": num_heads, "patch_size": 3}}
        return [patch, regular, regular]
    raise ValueError(att_type)


class AudioEfficientConformerEncoder(nn.Module):
    """Raw audio -> features (encoders.py:229): fbank (fp32, no
    normalisation) -> conv2d stem 1->180 k3 s2 + BN + swish -> channel-major
    flatten (180*40) -> Linear 180 -> conformer [180, 256, 360]."""

    def __init__(self, include_head: bool = True, vocab_size: int = 256,
                 att_type: str = "patch",
                 interctc_blocks: Sequence[int] = (3, 6, 10, 13),
                 num_blocks: Sequence[int] = (5, 6, 5),
                 loss_prefix: str = "ctc", use_flash: bool = False,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None):
        super().__init__()
        n_mels, filters, dims, heads = 80, 180, [180, 256, 360], 4
        self.preprocessing = AudioPreprocessing(
            sample_rate=16000, n_fft=512, win_length_ms=25, hop_length_ms=10,
            n_mels=n_mels, normalize=False)
        self.spec_augment = SpecAugment(mF=2, F=27, mT=5, pS=0.05)
        self.subsampling_module = ConvNeuralNetwork(
            1, [filters], 3, ndim=2, strides=2, act_fun="Swish")
        self.linear = Linear(filters * (n_mels // 2), dims[0])
        self.back_end = ConformerInterCTC(
            dims, list(num_blocks), list(interctc_blocks), vocab_size,
            _att_params_audio(att_type, heads, use_flash),
            loss_prefix=loss_prefix, fused_att=fused_att,
            fused_conv=fused_conv)
        self.head = Linear(dims[-1], vocab_size) if include_head else None

    def forward(self, x, lengths):
        x, lengths = self.preprocessing(x, lengths)       # (B, 80, T')
        x = self.spec_augment(x, lengths)                  # training only
        x, lengths = self.subsampling_module(x[:, None], lengths)
        b, c, f, t = x.shape                               # (B, 180, 40, T'')
        x = self.linear(x.permute(0, 3, 1, 2).reshape(b, t, c * f))
        x, lengths, inter = self.back_end(x, lengths, make_mask(t, lengths))
        if self.head is not None:
            x = self.head(x)
        return x, lengths, inter


class VisualEfficientConformerEncoder(nn.Module):
    """Lip video -> features (encoders.py:391): stem -> per-frame ResNet18
    (256) -> conformer [256, 360]."""

    def __init__(self, include_head: bool = True, vocab_size: int = 256,
                 interctc_blocks: Sequence[int] = (3, 6, 9),
                 num_blocks: Sequence[int] = (6, 6), loss_prefix: str = "ctc",
                 stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None):
        super().__init__()
        dims = [256, 360]
        self.front_end = nn.ModuleDict({
            "0": FusedVideoStem(stem_mode or _stem_mode()),
            "3": ResNet("ResNet18", dim_output=dims[0])})
        att = {"class": "RelPos1dMultiHeadAttention",
               "params": {"num_heads": 4}}
        self.back_end = ConformerInterCTC(
            dims, list(num_blocks), list(interctc_blocks), vocab_size, att,
            loss_prefix=loss_prefix, fused_att=fused_att,
            fused_conv=fused_conv)
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
                 fused_conv: Optional[bool] = None):
        super().__init__()
        dim = 360
        self.video_encoder = VisualEfficientConformerEncoder(
            include_head=False, vocab_size=vocab_size,
            interctc_blocks=v_interctc_blocks, num_blocks=v_num_blocks,
            loss_prefix="v_ctc", stem_mode=stem_mode, fused_att=fused_att,
            fused_conv=fused_conv)
        self.audio_encoder = AudioEfficientConformerEncoder(
            include_head=False, vocab_size=vocab_size,
            interctc_blocks=a_interctc_blocks, num_blocks=a_num_blocks,
            loss_prefix="a_ctc", use_flash=use_flash, fused_att=fused_att,
            fused_conv=fused_conv)
        self.fusion_module = FusionModule(dim, dim, dim)
        att = {"class": "RelPos1dMultiHeadAttention",
               "params": {"num_heads": 4}}
        self.audio_visual_encoder = ConformerInterCTC(
            dim, f_num_blocks, list(f_interctc_blocks), vocab_size, att,
            loss_prefix="f_ctc", fused_att=fused_att, fused_conv=fused_conv)
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
