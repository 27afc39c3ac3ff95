"""The audio-visual Efficient Conformer InterCTC on LRS2 + LRS3, the flagship
(configs/LRS23/AV/EffConfInterCTC.py), for the port's CLI:

    python -m avec_tpu_torch.main -c avec_tpu_torch/configs/lrs23_av.py \\
        -m training

61.7M parameters, B=16 with 4 accumulated micro-batches, bf16. Without
datasets/LRS2 and datasets/LRS3 the data are the JAX config's synthetic
stand-in (256 + 64 seeded samples of up to 4 s); without the 256-piece
tokenizer there is no decoder and no WER; the beam search takes the 6-gram
and GPT-Small where their files are on disk. With the LRW classifier's
checkpoint on disk its front end is loaded into the video encoder.
"""

import os

import torch

from avec_tpu_torch.configs import common
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.models.zoo import (AudioVisualEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.metrics import WordErrorRate
from avec_tpu_torch.train.model import Trainer

# Architecture (EffConfInterCTC.py:9-21)
vocab_size = 256
v_interctc_blocks = [3, 6]
a_interctc_blocks = [8, 11]
f_interctc_blocks = [2]
loss_weights = {"v_ctc_2": 0.5 / 3, "v_ctc_5": 0.5 / 3, "a_ctc_7": 0.5 / 3,
                "a_ctc_10": 0.5 / 3, "f_ctc_1": 0.5 / 3, "outputs": 0.5}

# LRW-pretrained front end (:23-25)
lrw_pretrained = True
lrw_checkpoint = "callbacks/LRW/EffConfCE/checkpoints_epoch_30_step_57247.ckpt"

# Beam search (:27-43)
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

# Training (:45-51)
batch_size = 16
accumulated_steps = 4
eval_training = False
precision = "bfloat16"
recompute_metrics = True
callback_path = "callbacks/LRS23/AV/EffConfInterCTC"

# Datasets (:93-108)
align = True
video_max_length = 400


def collate_fn() -> CollateFn:
    """:96-99: video and audio padded, their lengths; labels padded."""
    return CollateFn(
        inputs_params=[{"axis": 0, "padding": True}, {"axis": 3},
                       {"axis": 1, "padding": True}, {"axis": 4}],
        targets_params=({"axis": 2, "padding": True}, {"axis": 5}))


def front_end_key(key: str) -> str:
    """:88-90: the LRW net's "encoder." scope -> the AV video encoder's."""
    return key.replace("encoder.", "encoder.video_encoder.", 1)


def build(callback_path: str = callback_path, device="cuda",
          data_parallel: bool = False, seed: int = 0) -> common.Setup:
    """The setup on `device` (the card unless the caller passes "cpu"). The
    kernel routes come from AVEC_TPU_FUSED_FFN / _FUSED_ATT / _FUSED_CONV
    and AVEC_TPU_STEM, as the models read them."""
    device = resolve_device(device)
    model = AudioVisualEfficientConformerInterCTC(                  # :54-56
        vocab_size=vocab_size, v_interctc_blocks=v_interctc_blocks,
        a_interctc_blocks=a_interctc_blocks,
        f_interctc_blocks=f_interctc_blocks, device=device,
        generator=torch.Generator().manual_seed(seed))
    decoder = common.ctc_decoder(                                   # :58-71
        device, beamsearch, tokenizer_path, beam_size, ngram_path, ngram_tmp,
        ngram_alpha, ngram_beta, ngram_offset, neural_checkpoint,
        neural_alpha, neural_beta)
    trainer = Trainer(                                              # :73-78
        model=model, device=device, precision=precision, seed=seed,
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),
        loss_weights=loss_weights,
        metrics={"outputs": WordErrorRate()} if decoder else None,
        decoders={"outputs": decoder} if decoder else None,
        data_parallel=data_parallel)
    if lrw_pretrained and os.path.isfile(lrw_checkpoint):           # :80-91
        trainer.load(lrw_checkpoint, select=lambda k: "front_end" in k,
                     rename=front_end_key)
    if common.lrs_available():                                      # :110-132
        train_tf, eval_tf = common.video_transforms()
        training, evaluation = common.lrs_datasets(
            batch_size, collate_fn(),
            dict(video_max_length=video_max_length, video_transform=train_tf,
                 align=align),
            dict(video_transform=eval_tf, align=align))
    else:                                                           # :133-140
        training, evaluation = common.synthetic_datasets(
            batch_size, collate_fn(), 4 * 16000, vocab_size)
    return common.Setup(trainer, training, evaluation, callback_path,
                        precision, accumulated_steps, eval_training,
                        recompute_metrics, decoder=decoder)
