"""The audio-only Efficient Conformer CTC on LRS2 + LRS3
(configs/LRS23/AO/EffConfCTC.py), for the port's CLI:

    python -m avec_tpu_torch.main -c avec_tpu_torch/configs/lrs23_ao.py \\
        -m training

Patch attention in stage 1, no InterCTC block (one output, weight 1),
B=16 with 4 accumulated micro-batches, bf16. The LRS datasets load no video
(`load_video=False`); without them the data are the JAX config's synthetic
stand-in (256 + 64 seeded utterances of up to 16 s). The decoder follows
the LRS23 AV config: beam 16 with the 6-gram and GPT-Small where their
files are on disk, none without the tokenizer.
"""

import torch

from avec_tpu_torch.configs import common
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.metrics import WordErrorRate
from avec_tpu_torch.train.model import Trainer

# Architecture (EffConfCTC.py:7-11); no loss weights: every output weighs 1
vocab_size = 256
interctc_blocks = []
loss_weights = None
att_type = "patch"

# Training (:13-19)
batch_size = 16
accumulated_steps = 4
eval_training = False
precision = "bfloat16"
recompute_metrics = True
callback_path = "callbacks/LRS23/AO/EffConfCTC"

# Beam search (:21-35)
beam_search = True
tokenizer_path = "datasets/LRS3/tokenizerbpe256.json"
ngram_path = "datasets/LRS3/6gram_lrs23.arpa"
ngram_offset = 100
beam_size = 16
ngram_alpha = 0.6
ngram_beta = 1.0
ngram_tmp = 1.0
neural_checkpoint = "checkpoints_epoch_10_step_2860.ckpt"
neural_alpha = 0.6
neural_beta = 1.0

# Datasets (:65-67)
load_video = False
audio_max_length = 16 * 16000


def collate_fn() -> CollateFn:
    """:68-70: audio padded, its lengths; labels padded."""
    return CollateFn(
        inputs_params=[{"axis": 1, "padding": True}, {"axis": 4}],
        targets_params=({"axis": 2, "padding": True}, {"axis": 5}))


def build(callback_path: str = callback_path, device="cuda",
          data_parallel: bool = False, seed: int = 0) -> common.Setup:
    """The setup on `device` (the card unless the caller passes "cpu"); the
    kernel routes come from the AVEC_TPU_FUSED_* variables."""
    device = resolve_device(device)
    model = AudioEfficientConformerInterCTC(                        # :38-39
        vocab_size=vocab_size, att_type=att_type,
        interctc_blocks=interctc_blocks, device=device,
        generator=torch.Generator().manual_seed(seed))
    decoder = common.ctc_decoder(                                   # :41-55
        device, beam_search, tokenizer_path, beam_size, ngram_path,
        ngram_tmp, ngram_alpha, ngram_beta, ngram_offset, neural_checkpoint,
        neural_alpha, neural_beta)
    trainer = Trainer(                                              # :57-62
        model=model, device=device, precision=precision, seed=seed,
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),
        loss_weights=1.0 if loss_weights is None else loss_weights,
        metrics=WordErrorRate() if decoder else None, decoders=decoder,
        data_parallel=data_parallel)
    if common.lrs_available():                                      # :72-88
        training, evaluation = common.lrs_datasets(
            batch_size, collate_fn(),
            dict(audio_max_length=audio_max_length, load_video=load_video),
            dict(load_video=load_video))
    else:                                                           # :89-99
        training, evaluation = common.synthetic_datasets(
            batch_size, collate_fn(), audio_max_length, vocab_size,
            load_video=False)
    return common.Setup(trainer, training, evaluation, callback_path,
                        precision, accumulated_steps, eval_training,
                        recompute_metrics, decoder=decoder)
