"""What the LRS2/3 and LibriSpeech configs of the port share: the `Setup`
that `avec_tpu_torch.main` reads, and the pieces the JAX configs under
configs/LRS23 write out each time (the decoder with its fallbacks, the lip
video transforms, the LRS datasets or their synthetic stand-in)."""

import os
from dataclasses import dataclass
from typing import Any, Optional

from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.dataset import MultiDataset
from avec_tpu_torch.data.lrs import LRS
from avec_tpu_torch.data.synthetic import SyntheticAVDataset
from avec_tpu_torch.data.transforms import (CenterCrop, Compose, RandomCrop,
                                            RandomHorizontalFlip,
                                            TimeMaskSecond)
from avec_tpu_torch.train.model import Trainer

LM_CONFIG = "avec_tpu_torch.configs.lrs23_lm_gpt_small"
LM_CALLBACK_PATH = "callbacks/LRS23/LM/GPT-Small"
CROP_SIZE = (88, 88)


@dataclass
class Setup:
    """A config's trainer, datasets and the engine settings the CLI passes
    to `fit` (read with fallbacks, as the JAX main.py reads a config's
    globals). A setting left None is the CLI flag's or default's."""
    trainer: Trainer
    training_dataset: Any
    evaluation_dataset: Any
    callback_path: str
    precision: str
    accumulated_steps: int = 1
    eval_training: Optional[bool] = None
    recompute_metrics: bool = False
    epochs: Optional[int] = None
    decoder: Any = None


def lrs_available() -> bool:
    """Whether datasets/LRS2 and datasets/LRS3 are there (the JAX configs'
    test for the real data, e.g. configs/LRS23/AV/EffConfInterCTC.py:110)."""
    return os.path.isdir("datasets/LRS2") and os.path.isdir("datasets/LRS3")


def has_lm(neural_checkpoint: str) -> bool:
    """Whether the GPT-Small rescorer's checkpoint is on disk
    (EffConfInterCTC.py:42-43)."""
    return os.path.isfile(os.path.join(LM_CALLBACK_PATH, neural_checkpoint))


def ctc_decoder(device, beamsearch: bool, tokenizer_path: str,
                beam_size: int, ngram_path: str, ngram_tmp: float,
                ngram_alpha: float, ngram_beta: float, ngram_offset: int,
                neural_checkpoint: str, neural_alpha: float,
                neural_beta: float, test_time_aug: bool = False):
    """EffConfInterCTC.py:58-75: with the tokenizer, the beam search (the
    n-gram where its ARPA exists, GPT-Small rescoring where its checkpoint
    exists), or greedy without `beamsearch`; without the tokenizer, no
    decoder."""
    if not os.path.isfile(tokenizer_path):
        return None
    if not beamsearch:
        from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder

        return CTCGreedySearchDecoder(tokenizer_path=tokenizer_path)
    from avec_tpu_torch.decode.beam import CTCBeamSearchDecoder

    lm = has_lm(neural_checkpoint)
    return CTCBeamSearchDecoder(
        tokenizer_path=tokenizer_path, beam_size=beam_size,
        ngram_path=ngram_path if os.path.isfile(ngram_path) else None,
        ngram_tmp=ngram_tmp, ngram_alpha=ngram_alpha, ngram_beta=ngram_beta,
        ngram_offset=ngram_offset,
        neural_config_path=LM_CONFIG if lm else None,
        neural_checkpoint=neural_checkpoint, neural_alpha=neural_alpha,
        neural_beta=neural_beta, test_time_aug=test_time_aug, device=device)


def video_transforms():
    """EffConfInterCTC.py:102-108: random crop, flip and time mask for
    training; the centre crop for evaluation."""
    train = Compose([RandomCrop(CROP_SIZE), RandomHorizontalFlip(),
                     TimeMaskSecond(T_second=0.4, num_mask_second=1.0,
                                    fps=25.0, mean_frame=True)])
    return train, CenterCrop(CROP_SIZE)


def lrs_datasets(batch_size: int, collate_fn: CollateFn, train_kwargs,
                 eval_kwargs):
    """EffConfInterCTC.py:110-132: LRS2 pretrain+train+val and LRS3
    pretrain+trainval for training, the two test sets for evaluation;
    `train_kwargs` / `eval_kwargs` are each config's LRS arguments."""
    training = MultiDataset(
        batch_size=batch_size, collate_fn=collate_fn,
        datasets=[LRS(batch_size=None, collate_fn=None, version="LRS2",
                      mode="pretrain+train+val", **train_kwargs),
                  LRS(batch_size=None, collate_fn=None, version="LRS3",
                      mode="pretrain+trainval", **train_kwargs)])
    evaluation = [LRS(batch_size=batch_size, collate_fn=collate_fn,
                      version=v, mode="test", **eval_kwargs)
                  for v in ("LRS2", "LRS3")]
    return training, evaluation


def synthetic_datasets(batch_size: int, collate_fn: CollateFn,
                       audio_len: int, vocab_size: int, **kwargs):
    """EffConfInterCTC.py:133-140: 256 seeded training samples and 64 for
    evaluation (seed 123), when the LRS data are absent."""
    training = SyntheticAVDataset(num_samples=256, audio_len=audio_len,
                                  vocab_size=vocab_size,
                                  batch_size=batch_size,
                                  collate_fn=collate_fn, **kwargs)
    evaluation = [SyntheticAVDataset(num_samples=64, audio_len=audio_len,
                                     vocab_size=vocab_size,
                                     batch_size=batch_size,
                                     collate_fn=collate_fn, seed=123,
                                     **kwargs)]
    return training, evaluation
