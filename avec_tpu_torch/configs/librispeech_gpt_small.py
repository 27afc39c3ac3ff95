"""GPT-Small pretrained on the LibriSpeech LM corpus
(configs/LibriSpeechCorpus/GPT-Small.py), for the port's CLI:

    python -m avec_tpu_torch.main \\
        -c avec_tpu_torch/configs/librispeech_gpt_small.py -m training

The GPT's own defaults (AdamW under the cosine schedule of GPT-Small,
`models/zoo.py:GPT.compile_defaults`), B=128 with 2 accumulated
micro-batches, bf16; evaluated on the LRS2 / LRS3 test corpora. Without the
corpus or the tokenizer the data are the JAX config's synthetic stand-in.
"""

from avec_tpu_torch.configs import common
from avec_tpu_torch.configs.lrs23_lm_gpt_small import (build_model,
                                                       lm_datasets)
from avec_tpu_torch.models.zoo import resolve_device
from avec_tpu_torch.train.model import Trainer

# Architecture (GPT-Small.py:7-13), as in lrs23_lm_gpt_small
vocab_size = 1024
pad_token = 0
sos_token = vocab_size
eos_token = vocab_size

# Training (:15-20)
batch_size = 128
accumulated_steps = 2
tokenizer_path = "datasets/LRS3/tokenizerbpe1024.json"
precision = "bfloat16"
callback_path = "callbacks/LibriSpeechCorpus/GPT-Small"
tokenizer = tokenizer_path
corpus_path = "datasets/LibriSpeechCorpus/librispeech-lm-norm.txt"   # :37


def build(callback_path: str = callback_path, device="cuda",
          data_parallel: bool = False, seed: int = 0) -> common.Setup:
    """The setup on `device` (the card unless the caller passes "cpu")."""
    device = resolve_device(device)
    trainer = Trainer(model=build_model(device, seed),             # :22-27
                      device=device, precision=precision, seed=seed,
                      data_parallel=data_parallel)
    training, evaluation = lm_datasets(corpus_path, tokenizer_path,
                                       batch_size)                  # :37-59
    return common.Setup(trainer, training, evaluation, callback_path,
                        precision, accumulated_steps)
