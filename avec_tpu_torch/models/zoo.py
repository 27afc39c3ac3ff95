"""Task models (port of avec_tpu/models/zoo.py): the AV model, eval and
training forward.

Weights are drawn from an explicit `torch.Generator` (default seed 0) on the
CPU, so a seed gives the same model on every device, then moved to `device`.
Entry points default to CUDA and raise when it is absent.
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from avec_tpu_torch.models.encoders import AudioVisualEfficientConformerEncoder
from avec_tpu_torch.ops.layers import init_params


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


class AudioVisualEfficientConformerInterCTC(nn.Module):
    """AV Efficient Conformer with InterCTC (zoo.py:200-260).

    forward(video, video_len, audio, audio_len) returns
    {"outputs": [logits (B, T, vocab), lengths], "<prefix>_<i>": [...]}: with
    the reference blocks the six outputs `outputs`, `v_ctc_2`, `v_ctc_5`,
    `a_ctc_7`, `a_ctc_10`, `f_ctc_1`. The model is built in eval mode, where
    the forward records no graph; `.train()` does what `training=True` does
    in the JAX package (zoo.py:211-227)."""

    def __init__(self, vocab_size: int = 256,
                 v_interctc_blocks: Sequence[int] = (3, 6),
                 a_interctc_blocks: Sequence[int] = (8, 11),
                 f_interctc_blocks: Sequence[int] = (2,),
                 use_flash: bool = False,
                 v_num_blocks: Sequence[int] = (6, 1),
                 a_num_blocks: Sequence[int] = (5, 6, 1),
                 f_num_blocks: int = 5, stem_mode: Optional[str] = None,
                 fused_att: Optional[bool] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = AudioVisualEfficientConformerEncoder(
            vocab_size=vocab_size, v_interctc_blocks=v_interctc_blocks,
            a_interctc_blocks=a_interctc_blocks,
            f_interctc_blocks=f_interctc_blocks, v_num_blocks=v_num_blocks,
            a_num_blocks=a_num_blocks, f_num_blocks=f_num_blocks,
            use_flash=use_flash, stem_mode=stem_mode, fused_att=fused_att)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params(self, generator)
        self.eval()
        self.to(device)
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
        the dropout and SpecAugment masks, one on the CPU for the fused
        kernels' integer seeds (drawn without a device sync)."""
        device = next(self.parameters()).device
        noise = torch.Generator(device=device).manual_seed(seed)
        seeds = torch.Generator().manual_seed(seed + 1)
        for m in self.modules():
            if hasattr(m, "generator"):
                m.generator = noise
            if hasattr(m, "seed_generator"):
                m.seed_generator = seeds

    def kernel_launches_per_step(self) -> Dict[str, int]:
        """Kernel launches of one training forward + backward, derived from
        the module tree: every feed-forward module launches the fused forward
        and backward once, every flash attention layer the flash forward and
        both flash backward kernels once, every attention module that takes
        the fused route (with the key-padding masks the encoders build) the
        fused attention forward and backward once, and a "pallas" video stem
        its BN + ReLU + pool kernel once (its backward launches no kernel)."""
        from avec_tpu_torch.models.conformer import (AttentionModule,
                                                     FeedForwardModule)
        from avec_tpu_torch.models.encoders import FusedVideoStem
        from avec_tpu_torch.ops import (attention_module, ffn,
                                        flash_attention, stem)

        mods = list(self.modules())
        n_ffn = sum(isinstance(m, FeedForwardModule) for m in mods)
        n_flash = sum(bool(getattr(m, "use_flash", False)) for m in mods)
        n_att = sum(isinstance(m, AttentionModule) and m.fused_eligible()
                    for m in mods)
        n_stem = sum(isinstance(m, FusedVideoStem) and m.mode == "pallas"
                     for m in mods)
        counts = {ffn.KERNEL_FWD: n_ffn, ffn.KERNEL_BWD: n_ffn,
                  flash_attention.KERNEL: n_flash,
                  flash_attention.KERNEL_DQ: n_flash,
                  flash_attention.KERNEL_DKV: n_flash,
                  attention_module.KERNEL_FWD: n_att,
                  attention_module.KERNEL_BWD: n_att,
                  stem.KERNEL: n_stem}
        return {k: v for k, v in counts.items() if v}

    def forward(self, video, video_len, audio, audio_len):
        with torch.set_grad_enabled(self.training):
            x, lengths, inter = self.encoder(video, video_len, audio,
                                             audio_len)
        return {"outputs": [x, lengths], **inter}


def randomize_batch_stats(model: nn.Module, generator: torch.Generator):
    """Seeded, non-trivial BN running statistics (so eval BN is not the
    identity): mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)."""
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=generator) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=generator) + 0.5)
    return model
