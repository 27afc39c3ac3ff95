"""GPT-Small fine-tuned on the LRS2/3 transcripts, the beam search's
rescorer (configs/LRS23/LM/GPT-Small.py), for the port's CLI:

    python -m avec_tpu_torch.main \\
        -c avec_tpu_torch/configs/lrs23_lm_gpt_small.py -m training

It is also the `neural_config_path` module of the LRS23 AO / AV / VO
decoders (`decode/beam.py`): `build_model(device)`, `tokenizer` (the
1024-piece tokenizer's path), `pad_token`, `sos_token`, `eos_token` and
`callback_path`, from which the decoder reads the checkpoint it names.

AdamW (lr 6e-5, betas (0.9, 0.95), eps 1e-8, decay 0.1 on the Linear
weights), B=128 with 2 accumulated micro-batches, 10 epochs. With the
LibriSpeech GPT-Small checkpoint on disk its weights are loaded first.
Without the LRS corpus or the tokenizer the data are the JAX config's
synthetic stand-in (512 + 128 seeded sequences of up to 100 ids).
"""

import os

import torch

from avec_tpu_torch.configs import common
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.corpus_lm import CorpusLM
from avec_tpu_torch.data.synthetic import SyntheticLMDataset
from avec_tpu_torch.models.zoo import GPT, resolve_device
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.train.optim import AdamW, gpt_decay_mask

# Architecture (GPT-Small.py:8-14)
vocab_size = 1024
model = "GPT-Small"
max_pos_encoding = 2048
pad_token = 0
sos_token = vocab_size
eos_token = vocab_size

# Pretrained checkpoint (:16-19)
pretrained = True
pretrained_checkpoint = ("callbacks/LibriSpeechCorpus/GPT-Small/"
                         "checkpoints_epoch_13_step_512924.ckpt")

# Training (:21-28)
lr = 6e-5
epochs = 10
batch_size = 128
accumulated_steps = 2
tokenizer_path = "datasets/LRS3/tokenizerbpe1024.json"
precision = "bfloat16"
callback_path = "callbacks/LRS23/LM/GPT-Small"
tokenizer = tokenizer_path

# Datasets (:46)
label_max_length = 100
corpus_path = "datasets/LRS3/corpus_lrs23_pretrain+train+val.txt"


def build_model(device="cuda", seed: int = 0) -> GPT:
    """:31-33: GPT-Small over vocab 1025, pad 0, sinusoidal positions."""
    return GPT(vocab_size=vocab_size + 1, padding_idx=pad_token,
               max_pos_encoding=max_pos_encoding, model=model,
               pos_embedding="sin", device=device,
               generator=torch.Generator().manual_seed(seed))


def collate_fn() -> CollateFn:
    """:47-51: [sos] + ids padded with pad; ids + [eos] padded with -1."""
    return CollateFn(
        inputs_params=[{"axis": 0, "padding": True, "start_token": sos_token,
                        "padding_value": pad_token}],
        targets_params=[{"axis": 0, "padding": True, "end_token": eos_token,
                         "padding_value": -1}])


def lm_datasets(corpus: str, tokenizer: str, batch: int = batch_size):
    """:53-76: the corpus for training and the LRS2 / LRS3 test corpora for
    evaluation when the corpus and tokenizer are on disk, else 512 + 128
    seeded sequences (seed 123 for evaluation)."""
    if os.path.isfile(corpus) and os.path.isfile(tokenizer):
        training = CorpusLM(collate_fn=collate_fn(), batch_size=batch,
                            tokenizer_path=tokenizer,
                            max_length=label_max_length, corpus_path=corpus)
        evaluation = [CorpusLM(collate_fn=collate_fn(), batch_size=batch,
                               tokenizer_path=tokenizer,
                               corpus_path=f"datasets/{v}/corpus_test.txt")
                      for v in ("LRS2", "LRS3")]
        return training, evaluation
    training = SyntheticLMDataset(
        num_samples=512, max_length=label_max_length,
        vocab_size=vocab_size + 1, batch_size=batch, collate_fn=collate_fn())
    evaluation = [SyntheticLMDataset(
        num_samples=128, max_length=label_max_length,
        vocab_size=vocab_size + 1, batch_size=batch, collate_fn=collate_fn(),
        seed=123)]
    return training, evaluation


def build(callback_path: str = callback_path, device="cuda",
          data_parallel: bool = False, seed: int = 0,
          pretrained: bool = pretrained,
          tokenizer_path: str = tokenizer_path) -> common.Setup:
    """The setup on `device` (the card unless the caller passes "cpu")."""
    device = resolve_device(device)
    trainer = Trainer(                                              # :34-36
        model=build_model(device, seed), device=device, precision=precision,
        seed=seed, optimizer=AdamW(lr=lr, betas=(0.9, 0.95), eps=1e-8,
                                   weight_decay=0.1,
                                   decay_mask=gpt_decay_mask),
        data_parallel=data_parallel)
    if pretrained and os.path.isfile(pretrained_checkpoint):        # :38-43
        trainer.load(pretrained_checkpoint, select=lambda k: True)
    training, evaluation = lm_datasets(corpus_path, tokenizer_path)
    return common.Setup(trainer, training, evaluation, callback_path,
                        precision, accumulated_steps, epochs=epochs)
