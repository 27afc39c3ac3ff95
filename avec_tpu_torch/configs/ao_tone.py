"""The AO-Tone learning run with the port (configs/Synthetic/AO-Tone.py:20-82).

A self-contained audio-only task whose data and tokenizer the repo
generates: each token is a 100 ms tone at a token-specific frequency with a
50 ms gap. The model is the audio-only Efficient Conformer at the
flagship's widths with 5 conformer blocks (2, 2, 1) and InterCTC after
blocks 2 and 4.

    setup = build(callback_path="callbacks/AO-Tone-torch")   # on the card
    setup.trainer.fit(setup.train_loader, epochs=setup.epochs,
                      dataset_eval=setup.eval_loader,
                      callback_path=setup.callback_path,
                      recompute_metrics=setup.recompute_metrics)

The evaluation decodes as the config does: beam 8 with a 2-gram estimated
from the training transcripts and, once LM-Tone has trained
(`configs/lm_tone.py`), GPT rescoring (`lm_tone.tone_beam_decoder`).
`avec_tpu_torch/configs/ao_tone_causal.py` is the same run on the causal
variant, decoded greedily.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.data.synthetic import ToneSpeechDataset, tone_tokenizer
from avec_tpu_torch.configs import lm_tone
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.metrics import WordErrorRate
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.train.optim import Adam
from avec_tpu_torch.train.schedulers import NoamDecayScheduler

VOCAB_SIZE = 32                                    # AO-Tone.py:20
EPOCHS = 2                                         # :21
BATCH_SIZE = 16                                    # :22
PRECISION = "bfloat16"                             # :23
RECOMPUTE_METRICS = True                           # :24
TRAIN_SAMPLES, TRAIN_SEED = 6400, 0                # :37-38
EVAL_SAMPLES, EVAL_SEED = 64, 10_000_000           # :39-41
# :71-73, the model
MODEL = dict(vocab_size=VOCAB_SIZE, att_type="patch", num_blocks=(2, 2, 1),
             interctc_blocks=(2, 4))
# :76, mapped onto the sorted output names ctc_1, ctc_3, outputs
LOSS_WEIGHTS = [0.25, 0.25, 0.5]


def optimizer():
    """:77-80: Adam under Noam (warmup 300, dim 360, factor 1.5), betas
    (0.9, 0.98), eps 1e-9, L2 weight decay 1e-6."""
    return Adam(lr=NoamDecayScheduler(warmup_steps=300, dim_decay=360,
                                      val_factor=1.5),
                betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6)


@dataclass
class Setup:
    model: AudioEfficientConformerInterCTC
    trainer: Trainer
    train_set: ToneSpeechDataset
    eval_set: ToneSpeechDataset
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
          decoder: Optional[Callable[[str], Any]] = None,
          data_parallel: bool = False, **model_kwargs) -> Setup:
    """The AO-Tone setup on `device` (the card unless the caller passes
    "cpu"). `route` holds the model's kernel switches (`fused_ffn`,
    `fused_att`, `fused_conv`, `use_flash`); `model_kwargs` change the
    model (`causal`, `left_context`). The tone tokenizer is written to
    `callback_path`/tokenizer.json (:27-30). The training loader shuffles
    by epoch and drops a last partial batch, the evaluation loader keeps
    its order. The evaluation decoder is `decoder(tokenizer_path)`, or
    with None the config's, `lm_tone.tone_beam_decoder` (its 2-gram
    written to `callback_path`, GPT rescoring with the last LM-Tone
    checkpoint in `lm_tone.callback_path` if there is one). Smaller
    `train_samples`, `eval_samples` and `batch_size` cut the run for the
    CPU. `data_parallel` builds the trainer's data-parallel step (an
    initialized process group)."""
    device = resolve_device(device)
    os.makedirs(callback_path, exist_ok=True)
    tokenizer_path = os.path.join(callback_path, "tokenizer.json")
    tone_tokenizer(VOCAB_SIZE).save(tokenizer_path)
    train_set = ToneSpeechDataset(num_samples=train_samples,
                                  vocab_size=VOCAB_SIZE, seed=TRAIN_SEED,
                                  batch_size=batch_size)
    eval_set = ToneSpeechDataset(num_samples=eval_samples,
                                 vocab_size=VOCAB_SIZE, seed=EVAL_SEED,
                                 batch_size=batch_size, shuffle=False)
    model = AudioEfficientConformerInterCTC(
        device=device, generator=torch.Generator().manual_seed(seed),
        **{**MODEL, **model_kwargs, **(route or {})})
    trainer = Trainer(
        model=model, device=device, precision=precision, seed=seed,
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),   # :75
        loss_weights=LOSS_WEIGHTS, optimizer=optimizer(),
        metrics={"outputs": WordErrorRate()},                        # :81
        decoders={"outputs": lm_tone.tone_beam_decoder(
            callback_path, tokenizer_path, train_set, device)
            if decoder is None else decoder(tokenizer_path)},
        data_parallel=data_parallel)
    train_loader = DataLoader(train_set, batch_size=batch_size,
                              drop_last=True)
    eval_loader = DataLoader(eval_set, batch_size=batch_size,
                             drop_last=False)
    return Setup(model, trainer, train_set, eval_set, train_loader,
                 eval_loader, tokenizer_path, callback_path)
