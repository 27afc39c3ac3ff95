"""The LRW word-classification setup with the port: the synthetic branch of
configs/LRW/EffConfCE.py (the license-gated LRW data is not in the repo).

The model is the LRW classifier (`VisualEfficientConformerCE`, 500 words)
with its `compile` defaults: softmax cross-entropy, categorical accuracy
and Adam under the conformer's Noam schedule. The data are seeded random
clips of 29 frames of 88 x 88 with a word label each.

    setup = build(callback_path="callbacks/LRW-torch")        # on the card
    setup.trainer.fit(setup.train_loader, epochs=1,
                      dataset_eval=setup.eval_loader,
                      accumulated_steps=setup.accumulated_steps)

A checkpoint of this model carries the front end (video stem and ResNet18
trunk) that the VO and AV configs load into their own models
(`Trainer.load(path, select=lambda k: "front_end" in k)`).
"""

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.data.synthetic import SyntheticClassificationDataset
from avec_tpu_torch.models.zoo import (VisualEfficientConformerCE,
                                       resolve_device)
from avec_tpu_torch.train.model import Trainer

VOCAB_SIZE = 500                                   # EffConfCE.py:8
BATCH_SIZE = 32                                    # :11
ACCUMULATED_STEPS = 2                              # :12
PRECISION = "bfloat16"                             # :13
TRAIN_SAMPLES, EVAL_SAMPLES, EVAL_SEED = 256, 64, 123   # :40-45
callback_path = "callbacks/LRW/EffConfCE"          # :14


@dataclass
class Setup:
    model: VisualEfficientConformerCE
    trainer: Trainer
    train_set: SyntheticClassificationDataset
    eval_set: SyntheticClassificationDataset
    train_loader: DataLoader
    eval_loader: DataLoader
    callback_path: str
    accumulated_steps: int = ACCUMULATED_STEPS
    precision: str = PRECISION

    @property
    def training_dataset(self):
        """The training set, as `avec_tpu_torch.main` reads it."""
        return self.train_set

    @property
    def evaluation_dataset(self):
        """The evaluation set, as `avec_tpu_torch.main` reads it."""
        return self.eval_set


def build(callback_path: str = callback_path, device="cuda", route: Optional[Dict[str, Any]]
          = None, precision: str = PRECISION, seed: int = 0,
          batch_size: int = BATCH_SIZE, train_samples: int = TRAIN_SAMPLES,
          eval_samples: int = EVAL_SAMPLES,
          data_parallel: bool = False) -> Setup:
    """The LRW setup on `device` (the card unless the caller passes "cpu").
    `route` holds the model's kernel switches (`fused_ffn`, `fused_att`,
    `fused_conv`, `stem_mode`). The collate gives the clips as the one
    input and the labels as the targets (:21-22). Smaller sizes cut the run
    for the CPU. `data_parallel` builds the trainer's data-parallel step."""
    device = resolve_device(device)
    os.makedirs(callback_path, exist_ok=True)
    collate_fn = CollateFn(inputs_params=[{"axis": 0}],
                           targets_params=[{"axis": 1}])
    train_set = SyntheticClassificationDataset(
        num_samples=train_samples, num_classes=VOCAB_SIZE,
        batch_size=batch_size, collate_fn=collate_fn)
    eval_set = SyntheticClassificationDataset(
        num_samples=eval_samples, num_classes=VOCAB_SIZE,
        batch_size=batch_size, collate_fn=collate_fn, seed=EVAL_SEED)
    model = VisualEfficientConformerCE(
        vocab_size=VOCAB_SIZE, device=device,
        generator=torch.Generator().manual_seed(seed), **(route or {}))
    trainer = Trainer(model=model, device=device, precision=precision,
                      seed=seed, data_parallel=data_parallel)
    train_loader = DataLoader(train_set, batch_size=batch_size,
                              drop_last=True)
    eval_loader = DataLoader(eval_set, batch_size=batch_size,
                             drop_last=False)
    return Setup(model, trainer, train_set, eval_set, train_loader,
                 eval_loader, callback_path, precision=precision)
