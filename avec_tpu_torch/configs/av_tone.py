"""The AV-Tone learning run with the port (configs/Synthetic/AV-Tone.py:20-85).

A self-contained audio-visual task whose data and tokenizer the repo
generates: each token is a 100 ms tone with a 50 ms gap, and the video shows
a cell of an 8 x 8 grid that encodes the token. Tokens t and t + 15 sound
the same, so the word error rate falls only if the video path trains (the
Conv3d stem, ResNet18, the video conformer and the fusion module).

    setup = build(callback_path="callbacks/AV-Tone-torch")   # on the card
    setup.trainer.fit(setup.train_loader, epochs=setup.epochs,
                      dataset_eval=setup.eval_loader,
                      callback_path=setup.callback_path,
                      recompute_metrics=setup.recompute_metrics)

The evaluation decodes as the config does: beam 8 with a 2-gram estimated
from the training transcripts and, once LM-Tone has trained
(`configs/lm_tone.py`), GPT rescoring (`lm_tone.tone_beam_decoder`).
"""

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.data.synthetic import ToneAVSpeechDataset, tone_tokenizer
from avec_tpu_torch.configs import lm_tone
from avec_tpu_torch.models.zoo import (AudioVisualEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.metrics import WordErrorRate
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.train.optim import Adam
from avec_tpu_torch.train.schedulers import NoamDecayScheduler

VOCAB_SIZE = 32                                    # AV-Tone.py:24
EPOCHS = 2                                         # :25
BATCH_SIZE = 16                                    # :26
PRECISION = "bfloat16"                             # :27
RECOMPUTE_METRICS = True                           # :28
TRAIN_SAMPLES, TRAIN_SEED = 6400, 0                # :38-40
EVAL_SAMPLES, EVAL_SEED = 64, 10_000_000           # :41-44
# :72-75, the model's depth
MODEL = dict(vocab_size=VOCAB_SIZE, v_num_blocks=(2, 1),
             a_num_blocks=(2, 2, 1), f_num_blocks=2, v_interctc_blocks=(2,),
             a_interctc_blocks=(2, 4), f_interctc_blocks=(1,))
# :77-78
LOSS_WEIGHTS = {"v_ctc_1": 0.5 / 4, "a_ctc_1": 0.5 / 4, "a_ctc_3": 0.5 / 4,
                "f_ctc_0": 0.5 / 4, "outputs": 0.5}


def optimizer():
    """:79-82: Adam under Noam (warmup 300, dim 360, factor 1.5), betas
    (0.9, 0.98), eps 1e-9, L2 weight decay 1e-6."""
    return Adam(lr=NoamDecayScheduler(warmup_steps=300, dim_decay=360,
                                      val_factor=1.5),
                betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6)


@dataclass
class Setup:
    model: AudioVisualEfficientConformerInterCTC
    trainer: Trainer
    train_set: ToneAVSpeechDataset
    eval_set: ToneAVSpeechDataset
    train_loader: DataLoader
    eval_loader: DataLoader
    tokenizer_path: str
    callback_path: str
    epochs: int = EPOCHS
    recompute_metrics: bool = RECOMPUTE_METRICS

    @property
    def training_dataset(self):
        """The training set, as `avec_tpu_torch.main` reads it."""
        return self.train_set

    @property
    def evaluation_dataset(self):
        """The evaluation set, as `avec_tpu_torch.main` reads it."""
        return self.eval_set


def build(callback_path: str, device="cuda", route: Optional[Dict[str, Any]]
          = None, precision: str = PRECISION, seed: int = 0,
          batch_size: int = BATCH_SIZE, train_samples: int = TRAIN_SAMPLES,
          eval_samples: int = EVAL_SAMPLES,
          lm_callback_path: str = lm_tone.callback_path,
          data_parallel: bool = False) -> Setup:
    """The AV-Tone setup on `device` (the card unless the caller passes
    "cpu"). `route` holds the model's kernel switches (`fused_ffn`,
    `fused_att`, `fused_conv`, `stem_mode`, `use_flash`). The tone
    tokenizer is written to `callback_path`/tokenizer.json (:30-33). The
    training loader shuffles by epoch and drops a last partial batch, the
    evaluation loader keeps its order (the JAX CLI's loaders,
    avec_tpu/cli/functions.py:64-84). The decoder is
    `lm_tone.tone_beam_decoder` (its 2-gram written to `callback_path`),
    rescoring with the last LM-Tone checkpoint in `lm_callback_path` if
    there is one. Smaller `train_samples`, `eval_samples` and `batch_size`
    cut the run for the CPU. `data_parallel` builds the trainer's
    data-parallel step (an initialized process group)."""
    device = resolve_device(device)
    os.makedirs(callback_path, exist_ok=True)
    tokenizer_path = os.path.join(callback_path, "tokenizer.json")
    tone_tokenizer(VOCAB_SIZE).save(tokenizer_path)
    train_set = ToneAVSpeechDataset(num_samples=train_samples,
                                    vocab_size=VOCAB_SIZE, seed=TRAIN_SEED,
                                    batch_size=batch_size)
    eval_set = ToneAVSpeechDataset(num_samples=eval_samples,
                                   vocab_size=VOCAB_SIZE, seed=EVAL_SEED,
                                   batch_size=batch_size, shuffle=False)
    model = AudioVisualEfficientConformerInterCTC(
        device=device, generator=torch.Generator().manual_seed(seed),
        **MODEL, **(route or {}))
    trainer = Trainer(
        model=model, device=device, precision=precision, seed=seed,
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),   # :76
        loss_weights=LOSS_WEIGHTS, optimizer=optimizer(),
        metrics={"outputs": WordErrorRate()},                        # :83
        decoders={"outputs": lm_tone.tone_beam_decoder(
            callback_path, tokenizer_path, train_set, device,
            lm_callback_path)}, data_parallel=data_parallel)
    train_loader = DataLoader(train_set, batch_size=batch_size,
                              drop_last=True)
    eval_loader = DataLoader(eval_set, batch_size=batch_size,
                             drop_last=False)
    return Setup(model, trainer, train_set, eval_set, train_loader,
                 eval_loader, tokenizer_path, callback_path)
