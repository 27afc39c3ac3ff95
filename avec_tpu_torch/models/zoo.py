"""Task models (port of avec_tpu/models/zoo.py): the audio-visual, audio-only
(offline and causal), video-only and LRW word-classification models and the
GPT language model, eval and training forward.

Weights are drawn from an explicit `torch.Generator` (default seed 0) on the
CPU, so a seed gives the same model on every device, then moved to `device`.
Entry points default to CUDA and raise when it is absent. Each model's
`compile_defaults` are the JAX `compile` defaults the training engine takes
when its caller gives none: the loss, the loss weights (a list is mapped
onto the output names sorted, as the JAX engine maps it), the metrics and,
for the GPT, the optimizer.
"""

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from avec_tpu_torch.models.encoders import (
    AudioEfficientConformerEncoder, AudioVisualEfficientConformerEncoder,
    FusedVideoStem, VisualEfficientConformerEncoder)
from avec_tpu_torch.models.transformer import GPT_LR, GPTNet
from avec_tpu_torch.ops.layers import init_params
from avec_tpu_torch.train.losses import CTCLoss, SoftmaxCrossEntropy
from avec_tpu_torch.train.metrics import (CategoricalAccuracy,
                                          CategoricalAccuracyTopK)
from avec_tpu_torch.train.optim import AdamW, gpt_decay_mask
from avec_tpu_torch.train.schedulers import CosineAnnealingScheduler


# offset of each rank's Dropout / SpecAugment generator seed
_RANK_SEED_STRIDE = 1_000_003

# zoo.py:254-256 (configs/LRS23/AV/EffConfInterCTC.py:14-21)
AV_LOSS_WEIGHTS = {"v_ctc_2": 0.5 / 3, "v_ctc_5": 0.5 / 3, "a_ctc_7": 0.5 / 3,
                   "a_ctc_10": 0.5 / 3, "f_ctc_1": 0.5 / 3, "outputs": 0.5}


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


def hflip(video: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of (B, T, H, W, C) frames: the VO config's test-time
    augmentation (configs/LRS23/VO/EffConfInterCTC.py:45-48)."""
    return torch.flip(video, dims=(3,))


class ZooModel(nn.Module):
    """What every task model shares: seeded initialisation, the kernel,
    regularization, noise and data-parallel switches, and the kernel
    launches of a training step counted from the model's own module tree."""

    def _finish_init(self, device, generator: Optional[torch.Generator]):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params(self, generator)
        self.eval()
        self.to(device)
        self.process_group, self.dp_rank = None, 0
        self.set_generators(0)

    def set_kernels(self, enabled: bool) -> None:
        """Route every kernel-holding module through its CUDA kernel (True)
        or through the kernel's plain version (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = enabled

    def set_regularization(self, enabled: bool) -> None:
        """Dropout and SpecAugment on (True) or off (False) in training
        mode; batch statistics and the fused kernels stay as they are."""
        for m in self.modules():
            if hasattr(m, "regularize"):
                m.regularize = enabled

    def set_generators(self, seed: int) -> None:
        """Seed the training noise: one generator on the model's device for
        the dropout masks and SpecAugment's time masks, one on the CPU for
        the fused kernels' integer seeds (drawn without a device sync), and
        one on the model's device for SpecAugment's frequency bands. In
        data-parallel mode the first is offset by the rank in the data
        group, so data ranks draw different dropout and time masks and the
        ranks of one model group (tensor parallelism) draw the same masks
        on their replicated activations; the other two are not: the fused
        kernels' wrappers offset the seeds they draw per rank as the JAX DP
        wrappers do, and every rank draws the same frequency bands for the
        global batch, as the JAX step draws them once from one key
        (audio.py:217-224)."""
        self.noise_seed = seed
        device = next(self.parameters()).device
        noise = torch.Generator(device=device).manual_seed(
            seed + _RANK_SEED_STRIDE * self.dp_rank)
        seeds = torch.Generator().manual_seed(seed + 1)
        bands = torch.Generator(device=device).manual_seed(seed + 2)
        for m in self.modules():
            if hasattr(m, "generator"):
                m.generator = noise
            if hasattr(m, "seed_generator"):
                m.seed_generator = seeds
            if hasattr(m, "band_generator"):
                m.band_generator = bands

    def set_data_parallel(self, group=None) -> None:
        """Data-parallel training over the ranks of `group` (None: the
        default process group, which must be initialized): every BatchNorm
        syncs its batch statistics over the group, the feed-forward,
        attention and convolution modules take their fused kernels' DP forms
        (the convolution module's is K3dp, with global statistics), and the
        Dropout and SpecAugment time-mask generator is offset by the rank. The
        "pallas" video stem computes single-device batch statistics
        (pallas_stem.py:38-42), so with more than one rank it raises
        ValueError: train with stem "2d"."""
        group = group if group is not None else dist.group.WORLD
        if dist.get_world_size(group) > 1 and any(
                isinstance(m, FusedVideoStem) and m.mode == "pallas"
                for m in self.modules()):
            raise ValueError("the 'pallas' video stem has no cross-rank "
                             "batch statistics; train data-parallel with "
                             "stem_mode='2d'")
        for m in self.modules():      # the model itself among them
            if hasattr(m, "process_group"):
                m.process_group = group
        self.dp_rank = dist.get_rank(group)
        self.set_generators(self.noise_seed)

    def kernel_launches_per_step(self) -> Dict[str, int]:
        """Kernel launches of one training forward + backward, derived from
        the module tree: every feed-forward module that takes the fused
        route launches the fused forward and backward once, every flash
        attention layer the flash forward and both flash backward kernels
        once, every attention module that takes
        the fused route (non-causal `RelPos1dMultiHeadAttention` with the
        key-padding masks the encoders build) the
        fused attention forward and backward once, every convolution module
        that takes the fused route the four conv kernels (statistics,
        forward, backward-1, backward-2) once each, under their K3dp names in
        data-parallel mode, and a "pallas" video stem its BN + ReLU + pool
        kernel once (its backward launches no kernel). A rematerialized
        block (`remat=True`) launches the forward kernels of its modules a
        second time, in the backward's recompute. In data-parallel mode
        these are the launches of each rank."""
        from avec_tpu_torch.models.conformer import (AttentionModule,
                                                     ConformerInterCTC,
                                                     ConvolutionModule,
                                                     FeedForwardModule)
        from avec_tpu_torch.ops import (attention_module, conv_module, ffn,
                                        flash_attention, stem)
        from avec_tpu_torch.ops.attention import RelPos1dMultiHeadAttention

        mods = list(self.modules())
        n_ffn = sum(isinstance(m, FeedForwardModule) and m.fused_eligible()
                    for m in mods)
        # the flash route is RelPos1d's alone, never causal: the causal
        # encoder's layers are Transformer-XL ones
        n_flash = sum(isinstance(m, RelPos1dMultiHeadAttention)
                      and m.use_flash and not m.causal for m in mods)
        n_att = sum(isinstance(m, AttentionModule) and m.fused_eligible()
                    for m in mods)
        n_conv = sum(isinstance(m, ConvolutionModule) and m.fused_eligible()
                     for m in mods)
        n_stem = sum(isinstance(m, FusedVideoStem) and m.mode == "pallas"
                     for m in mods)
        conv_names = (conv_module.KERNELS if self.process_group is None
                      else conv_module.KERNELS_DP)
        counts = {ffn.KERNEL_FWD: n_ffn, ffn.KERNEL_BWD: n_ffn,
                  flash_attention.KERNEL: n_flash,
                  flash_attention.KERNEL_DQ: n_flash,
                  flash_attention.KERNEL_DKV: n_flash,
                  attention_module.KERNEL_FWD: n_att,
                  attention_module.KERNEL_BWD: n_att,
                  **{name: n_conv for name in conv_names},
                  stem.KERNEL: n_stem}
        for m in mods:
            if not (isinstance(m, ConformerInterCTC) and m.remat):
                continue
            for i in m.remat_blocks:
                again = list(m.conformer_blocks[i].modules())
                counts[ffn.KERNEL_FWD] += sum(
                    isinstance(x, FeedForwardModule) and x.fused_eligible()
                    for x in again)
                counts[flash_attention.KERNEL] += sum(
                    isinstance(x, RelPos1dMultiHeadAttention) and x.use_flash
                    and not x.causal for x in again)
                counts[attention_module.KERNEL_FWD] += sum(
                    isinstance(x, AttentionModule) and x.fused_eligible()
                    for x in again)
                for name in conv_names[:2]:       # statistics and forward
                    counts[name] += sum(
                        isinstance(x, ConvolutionModule)
                        and x.fused_eligible() for x in again)
        return {k: v for k, v in counts.items() if v}


class AudioVisualEfficientConformerInterCTC(ZooModel):
    """AV Efficient Conformer with InterCTC (zoo.py:200-260).

    forward(video, video_len, audio, audio_len) returns
    {"outputs": [logits (B, T, vocab), lengths], "<prefix>_<i>": [...]}: with
    the reference blocks the six outputs `outputs`, `v_ctc_2`, `v_ctc_5`,
    `a_ctc_7`, `a_ctc_10`, `f_ctc_1`. The model is built in eval mode, where
    the forward records no graph; `.train()` does what `training=True` does
    in the JAX package (zoo.py:211-227). `remat=True` rematerializes the
    conformer blocks of the JAX plan's uniform runs in training (15 of the
    reference depth's 24; `ConformerInterCTC`): the same step, with less
    memory and the blocks' forward run twice."""

    model_name = "Audio-Visual Efficient Conformer Inter CTC"    # zoo.py:241

    def __init__(self, vocab_size: int = 256,
                 v_interctc_blocks: Sequence[int] = (3, 6),
                 a_interctc_blocks: Sequence[int] = (8, 11),
                 f_interctc_blocks: Sequence[int] = (2,),
                 use_flash: bool = False,
                 v_num_blocks: Sequence[int] = (6, 1),
                 a_num_blocks: Sequence[int] = (5, 6, 1),
                 f_num_blocks: int = 5, stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, remat: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = AudioVisualEfficientConformerEncoder(
            vocab_size=vocab_size, v_interctc_blocks=v_interctc_blocks,
            a_interctc_blocks=a_interctc_blocks,
            f_interctc_blocks=f_interctc_blocks, v_num_blocks=v_num_blocks,
            a_num_blocks=a_num_blocks, f_num_blocks=f_num_blocks,
            use_flash=use_flash, stem_mode=stem_mode, fused_att=fused_att,
            fused_conv=fused_conv, fused_ffn=fused_ffn, remat=remat)
        self._finish_init(device, generator)

    def compile_defaults(self) -> Dict:
        return {"loss": CTCLoss(), "loss_weights": dict(AV_LOSS_WEIGHTS),
                "metrics": None}


    def forward(self, video, video_len, audio, audio_len):
        with torch.set_grad_enabled(self.training):
            x, lengths, inter = self.encoder(video, video_len, audio,
                                             audio_len)
        return {"outputs": [x, lengths], **inter}




class AudioEfficientConformerInterCTC(ZooModel):
    """Audio-only Efficient Conformer with InterCTC (zoo.py:82-144).

    forward(audio (B, Ta), audio_len (B,)) returns {"outputs": [logits
    (B, T, vocab), lengths], "ctc_<i>": [...]} for the InterCTC blocks.
    `att_type` "patch" (stage 1 patch attention, stages 2-3 regular),
    "regular", or "grouped" (grouped Transformer-XL attention, groups of 3
    frames in stage 1 and 1 in stages 2-3; plain products, no kernel);
    `use_flash` routes the regular layers through the flash
    kernel. `causal=True` is the causal variant's offline path with a
    `left_context` of stage-1 frames (`AudioEfficientConformerEncoder`)."""

    model_name = "Audio Efficient Conformer Inter CTC"           # zoo.py:127

    def __init__(self, vocab_size: int = 256, att_type: str = "patch",
                 interctc_blocks: Sequence[int] = (3, 6, 10, 13),
                 num_blocks: Sequence[int] = (5, 6, 5),
                 use_flash: bool = False, causal: bool = False,
                 left_context: Optional[int] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = AudioEfficientConformerEncoder(
            vocab_size=vocab_size, att_type=att_type,
            interctc_blocks=interctc_blocks, num_blocks=num_blocks,
            use_flash=use_flash, causal=causal, left_context=left_context,
            fused_att=fused_att, fused_conv=fused_conv, fused_ffn=fused_ffn)
        self._finish_init(device, generator)

    def compile_defaults(self) -> Dict:
        return {"loss": CTCLoss(), "loss_weights": [0.5 / 4] * 4 + [0.5],
                "metrics": None}

    def forward(self, audio, audio_len):
        with torch.set_grad_enabled(self.training):
            x, lengths, inter = self.encoder(audio, audio_len)
        return {"outputs": [x, lengths], **inter}


class VisualEfficientConformerInterCTC(ZooModel):
    """Video-only Efficient Conformer with InterCTC (zoo.py:147-197).

    forward(video (B, Tv, 88, 88, 1), video_len (B,)) returns
    {"outputs": [logits, lengths], "ctc_<i>": [...]}. In eval, each function
    of `test_augments` (video -> video, e.g. `hflip`) runs the encoder once
    more, and the outputs' logits and lengths are the base and augmented
    forwards stacked on a new axis 1: (B, 1 + n, T, vocab), (B, 1 + n)."""

    model_name = "Visual Efficient Conformer Inter CTC"          # zoo.py:181

    def __init__(self, vocab_size: int = 256,
                 interctc_blocks: Sequence[int] = (3, 6, 9),
                 num_blocks: Sequence[int] = (6, 6),
                 test_augments: Optional[Sequence[Callable]] = None,
                 stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if test_augments is not None and not isinstance(test_augments,
                                                        (list, tuple)):
            test_augments = [test_augments]
        self.test_augments = list(test_augments or [])
        self.encoder = VisualEfficientConformerEncoder(
            vocab_size=vocab_size, interctc_blocks=interctc_blocks,
            num_blocks=num_blocks, stem_mode=stem_mode, fused_att=fused_att,
            fused_conv=fused_conv, fused_ffn=fused_ffn)
        self._finish_init(device, generator)

    def compile_defaults(self) -> Dict:
        return {"loss": CTCLoss(), "loss_weights": [0.5 / 3] * 3 + [0.5],
                "metrics": None}

    def forward(self, video, video_len):
        with torch.set_grad_enabled(self.training):
            x, lengths, inter = self.encoder(video, video_len)
            if not self.training and self.test_augments:
                xs, lens = [x], [lengths]
                for aug in self.test_augments:
                    xa, la, _ = self.encoder(aug(video), video_len)
                    xs.append(xa)
                    lens.append(la)
                x, lengths = torch.stack(xs, dim=1), torch.stack(lens, dim=1)
        return {"outputs": [x, lengths], **inter}


class Classifier(ZooModel):
    """A classifier's `compile` defaults (models.py `Classifier`, zoo.py:
    41-53): softmax cross-entropy and categorical accuracy."""

    def compile_defaults(self) -> Dict:
        return {"loss": SoftmaxCrossEntropy(), "loss_weights": None,
                "metrics": CategoricalAccuracy()}


class VisualEfficientConformerCE(Classifier):
    """The LRW word classifier (zoo.py:56-79): the video encoder without
    InterCTC blocks, its logits averaged over every frame (no lengths:
    clips have one length). forward(video (B, T, 88, 88, 1)) returns
    {"output": logits (B, vocab)}."""

    model_name = "Visual Efficient Conformer CE"                 # zoo.py:71

    def __init__(self, vocab_size: int = 500,
                 num_blocks: Sequence[int] = (6, 6),
                 stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None,
                 fused_conv: Optional[bool] = None,
                 fused_ffn: Optional[bool] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = VisualEfficientConformerEncoder(
            vocab_size=vocab_size, interctc_blocks=(), num_blocks=num_blocks,
            stem_mode=stem_mode, fused_att=fused_att, fused_conv=fused_conv,
            fused_ffn=fused_ffn)
        self._finish_init(device, generator)

    def forward(self, video):
        with torch.set_grad_enabled(self.training):
            x, _, _ = self.encoder(video, None)
        return {"output": x.mean(dim=1)}


class GPT(GPTNet, Classifier):
    """The GPT language model (zoo.py:263-290; `models/transformer.py`).

    forward(ids (B, L) int) returns {"output": logits (B, L, vocab)}; the
    model runs in the dtype of its fp32 parameters. Its `compile` defaults:
    softmax cross-entropy over (B, L, vocab) logits, accuracy and top-10
    accuracy on "output", and AdamW (betas (0.9, 0.95), eps 1e-8, decay 0.1
    on the Linear weights) under the cosine schedule of the size's GPT_LR
    (warmup 750, end 520000); "AdamW" is the name of that default
    (`Trainer(optimizer="AdamW")`). Sharded by `Trainer(model_parallel=,
    param_sharding_rules=gpt_tensor_parallel_rules())`, its layers run
    on the shards (`parallel/tensor_parallel.py:shard_module`)."""

    def __init__(self, vocab_size: int = 25000,
                 padding_idx: Optional[int] = None,
                 max_pos_encoding: int = 2048, model: str = "GPT-Small",
                 pos_embedding: str = "learned", drop_rate: float = 0.1,
                 device="cuda", generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(vocab_size=vocab_size, padding_idx=padding_idx,
                         max_pos_encoding=max_pos_encoding, model=model,
                         pos_embedding=pos_embedding, drop_rate=drop_rate)
        self.model_size = model
        self.model_name = model                                  # zoo.py:269
        self._finish_init(device, generator)

    def compile_defaults(self) -> Dict:
        lr_max, lr_min = GPT_LR[self.model_size]
        return {"loss": SoftmaxCrossEntropy(transpose_logits=True),
                "loss_weights": None,
                "metrics": {"output": [CategoricalAccuracy(),
                                       CategoricalAccuracyTopK(topk=10)]},
                "optimizer": AdamW(
                    lr=CosineAnnealingScheduler(warmup_steps=750,
                                                val_max=lr_max,
                                                val_min=lr_min,
                                                end_step=520000),
                    betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                    decay_mask=gpt_decay_mask),
                "optimizer_name": "AdamW"}

    def forward(self, ids):
        with torch.set_grad_enabled(self.training):
            return {"output": super().forward(ids)}


model_dict = {
    "Classifier": Classifier,
}


def randomize_batch_stats(model: nn.Module, generator: torch.Generator):
    """Seeded, non-trivial BN running statistics (so eval BN is not the
    identity): mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)."""
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=generator) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=generator) + 0.5)
    return model
