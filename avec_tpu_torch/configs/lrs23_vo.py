"""The video-only Efficient Conformer InterCTC on LRS2 + LRS3
(configs/LRS23/VO/EffConfInterCTC.py), for the port's CLI:

    python -m avec_tpu_torch.main -c avec_tpu_torch/configs/lrs23_vo.py \\
        -m training

InterCTC after blocks 3, 6 and 9, B=16 with 4 accumulated micro-batches,
bf16. The LRS datasets load no audio; without them the data are the JAX
config's synthetic stand-in. With the LRW classifier's checkpoint on disk
its front end is loaded (the same keys). The decoder follows the LRS23 AV
config, with the horizontal-flip test-time augmentation off as there.
"""

import os

import torch

from avec_tpu_torch.configs import common
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.models.zoo import (VisualEfficientConformerInterCTC,
                                       hflip, resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.metrics import WordErrorRate
from avec_tpu_torch.train.model import Trainer

# Architecture (EffConfInterCTC.py:7-10): weights over the sorted outputs
# ctc_2, ctc_5, ctc_8, outputs
vocab_size = 256
interctc_blocks = [3, 6, 9]
loss_weights = [0.5 / 3, 0.5 / 3, 0.5 / 3, 0.5]

# LRW-pretrained front end (:12-14)
lrw_pretrained = True
lrw_checkpoint = "callbacks/LRW/EffConfCE/checkpoints_epoch_30_step_57247.ckpt"

# Test-time augmentation: the horizontal flip branch (:16-17)
test_time_aug = False

# Beam search (:19-33)
beamsearch = True
beam_size = 16
tokenizer_path = "datasets/LRS3/tokenizerbpe256.json"
ngram_path = "datasets/LRS3/6gram_lrs23.arpa"
ngram_offset = 100
ngram_alpha = 0.6
ngram_beta = 1.0
ngram_tmp = 1.0
neural_checkpoint = "checkpoints_epoch_10_step_2860.ckpt"
neural_alpha = 0.6
neural_beta = 1.0

# Training (:35-41)
batch_size = 16
accumulated_steps = 4
eval_training = False
precision = "bfloat16"
recompute_metrics = True
callback_path = "callbacks/LRS23/VO/EffConfInterCTC"

# Datasets (:88-90)
video_max_length = 400
label_max_length = 100


def collate_fn() -> CollateFn:
    """:91-93: video padded, its lengths; labels padded."""
    return CollateFn(
        inputs_params=[{"axis": 0, "padding": True}, {"axis": 3}],
        targets_params=({"axis": 2, "padding": True}, {"axis": 5}))


def build(callback_path: str = callback_path, device="cuda",
          data_parallel: bool = False, seed: int = 0) -> common.Setup:
    """The setup on `device` (the card unless the caller passes "cpu"); the
    kernel routes come from the AVEC_TPU_FUSED_* variables and
    AVEC_TPU_STEM."""
    device = resolve_device(device)
    model = VisualEfficientConformerInterCTC(                       # :50-53
        vocab_size=vocab_size, interctc_blocks=interctc_blocks,
        test_augments=[hflip] if test_time_aug else None, device=device,
        generator=torch.Generator().manual_seed(seed))
    decoder = common.ctc_decoder(                                   # :55-68
        device, beamsearch, tokenizer_path, beam_size, ngram_path, ngram_tmp,
        ngram_alpha, ngram_beta, ngram_offset, neural_checkpoint,
        neural_alpha, neural_beta, test_time_aug=test_time_aug)
    trainer = Trainer(                                              # :70-75
        model=model, device=device, precision=precision, seed=seed,
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),
        loss_weights=loss_weights,
        metrics={"outputs": WordErrorRate()} if decoder else None,
        decoders={"outputs": decoder} if decoder else None,
        data_parallel=data_parallel)
    if lrw_pretrained and os.path.isfile(lrw_checkpoint):           # :77-86
        trainer.load(lrw_checkpoint, select=lambda k: "front_end" in k)
    if common.lrs_available():                                      # :103-129
        train_tf, eval_tf = common.video_transforms()
        training, evaluation = common.lrs_datasets(
            batch_size, collate_fn(),
            dict(video_max_length=video_max_length,
                 label_max_length=label_max_length, video_transform=train_tf,
                 load_audio=False),
            dict(video_transform=eval_tf, load_audio=False))
    else:                                                           # :130-137
        training, evaluation = common.synthetic_datasets(
            batch_size, collate_fn(), 4 * 16000, vocab_size,
            load_audio=False)
    return common.Setup(trainer, training, evaluation, callback_path,
                        precision, accumulated_steps, eval_training,
                        recompute_metrics, decoder=decoder)
