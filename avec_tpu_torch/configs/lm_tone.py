"""The LM-Tone run with the port (configs/Synthetic/LM-Tone.py): GPT-Tiny
trained on the tone corpus, the GPT rescorer of the AV-Tone and AO-Tone
decoders.

The corpus is the transcripts of 512 tone utterances ("w3 w17 ..."), one
word per token of the tone tokenizer (vocab 32); the GPT's vocabulary adds
sos (32) and eos (33), pad is 0. Inputs are [sos] + ids padded with pad,
targets ids + [eos] padded with -1 (ignored). GPT-Tiny (d 64, 2 blocks, 2
heads), sinusoidal positions up to 64, fp32, AdamW lr 3e-4, betas (0.9,
0.95), eps 1e-8, weight decay 0.1 on the Linear weights; 1 epoch at batch
16; accuracy and top-10 accuracy on the evaluation pass over the corpus.

    setup = build()                     # on the card, into callback_path
    setup.trainer.fit(setup.train_loader, epochs=setup.epochs,
                      dataset_eval=setup.eval_loader,
                      callback_path=setup.callback_path)

As a decoder's rescorer config (`decode.beam.CTCBeamSearchDecoder(
neural_config_path="avec_tpu_torch.configs.lm_tone")`) the module gives
`build_model`, `tokenizer`, `pad_token`, `sos_token`, `eos_token` and
`callback_path`.
"""

import os
from dataclasses import dataclass
from typing import Optional

import torch

from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.corpus_lm import CorpusLM
from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.data.synthetic import ToneSpeechDataset, tone_tokenizer
from avec_tpu_torch.models.zoo import GPT, resolve_device
from avec_tpu_torch.train.checkpoint import find_last_checkpoint
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.train.optim import AdamW, gpt_decay_mask

VOCAB_SIZE = 32                                    # LM-Tone.py:10-11
pad_token = 0                                      # :12-14
sos_token = VOCAB_SIZE
eos_token = VOCAB_SIZE + 1
EPOCHS = 1                                         # :16
BATCH_SIZE = 16                                    # :17
PRECISION = "float32"                              # :18
CORPUS_SAMPLES, MAX_LENGTH = 512, 32               # :36-50
callback_path = "callbacks/LM-Tone-torch"
tokenizer = tone_tokenizer(VOCAB_SIZE)


def build_model(device="cuda", seed: int = 0) -> GPT:
    """:25-26: GPT-Tiny over vocab 34, pad 0, sinusoidal positions, 64."""
    return GPT(vocab_size=VOCAB_SIZE + 2, padding_idx=pad_token,
               max_pos_encoding=64, model="GPT-Tiny", pos_embedding="sin",
               device=device, generator=torch.Generator().manual_seed(seed))


def optimizer():
    """:27-29."""
    return AdamW(lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                 decay_mask=gpt_decay_mask)


def collate_fn() -> CollateFn:
    """:40-44: [sos] + ids padded with pad; ids + [eos] padded with -1."""
    return CollateFn(
        inputs_params=[{"axis": 0, "padding": True, "start_token": sos_token,
                        "padding_value": pad_token}],
        targets_params=[{"axis": 0, "padding": True, "end_token": eos_token,
                         "padding_value": -1}])


def last_checkpoint(path: str) -> Optional[str]:
    """The absolute path of the largest-step checkpoint under `path`, or
    None: what a decoder's `neural_checkpoint` takes."""
    name = find_last_checkpoint(path) if os.path.isdir(path) else None
    return None if name is None else os.path.abspath(os.path.join(path, name))


@dataclass
class Setup:
    model: GPT
    trainer: Trainer
    train_set: CorpusLM
    eval_set: CorpusLM
    train_loader: DataLoader
    eval_loader: DataLoader
    corpus_path: str
    callback_path: str
    epochs: int = EPOCHS

    @property
    def training_dataset(self):
        """The training set, as `avec_tpu_torch.main` reads it."""
        return self.train_set

    @property
    def evaluation_dataset(self):
        """The evaluation set, as `avec_tpu_torch.main` reads it."""
        return self.eval_set


def build(callback_path: str = callback_path, device="cuda", seed: int = 0,
          batch_size: int = BATCH_SIZE,
          corpus_samples: int = CORPUS_SAMPLES,
          data_parallel: bool = False) -> Setup:
    """The LM-Tone setup on `device` (the card unless the caller passes
    "cpu"). The corpus is written to `callback_path`/corpus.txt (:32-38).
    The training set rejects lines over MAX_LENGTH tokens; the evaluation
    set is the same corpus in order."""
    device = resolve_device(device)
    os.makedirs(callback_path, exist_ok=True)
    corpus_path = os.path.join(callback_path, "corpus.txt")
    with open(corpus_path, "w") as f:
        f.write("\n".join(ToneSpeechDataset(num_samples=corpus_samples,
                                            seed=0).corpus_lines()) + "\n")
    train_set = CorpusLM(batch_size=batch_size, collate_fn=collate_fn(),
                         tokenizer_path=tokenizer, max_length=MAX_LENGTH,
                         corpus_path=corpus_path)
    eval_set = CorpusLM(batch_size=batch_size, collate_fn=collate_fn(),
                        tokenizer_path=tokenizer, corpus_path=corpus_path,
                        shuffle=False)
    model = build_model(device, seed)
    trainer = Trainer(model=model, device=device, precision=PRECISION,
                      seed=seed, optimizer=optimizer(),
                      data_parallel=data_parallel)
    train_loader = DataLoader(train_set, batch_size=batch_size,
                              drop_last=True)
    eval_loader = DataLoader(eval_set, batch_size=batch_size,
                             drop_last=False)
    return Setup(model, trainer, train_set, eval_set, train_loader,
                 eval_loader, corpus_path, callback_path)


NGRAM_OFFSET = 100          # AV-Tone.py:47-55, AO-Tone.py:46-54
NGRAM_ORDER = 2


def tone_beam_decoder(callback_path: str, tokenizer_path: str, train_set,
                      device="cuda", lm_callback_path: str = callback_path):
    """The AV-Tone and AO-Tone decoder (AV-Tone.py:47-68, AO-Tone.py:46-66):
    beam 8 with a 2-gram (alpha 0.4, beta 0.6) that `estimate_arpa` builds
    from `train_set`'s transcripts into `callback_path`/2gram.arpa, words
    chr(id + 100); and GPT rescoring (0.3, 0.3) by this config's GPT when
    `lm_callback_path` holds an LM-Tone checkpoint (its last)."""
    from avec_tpu_torch.decode.beam import CTCBeamSearchDecoder
    from avec_tpu_torch.decode.ngram import estimate_arpa

    ngram_path = os.path.join(callback_path, f"{NGRAM_ORDER}gram.arpa")
    estimate_arpa([[chr(NGRAM_OFFSET + int(t)) for t in train_set.token_ids(i)]
                   for i in range(len(train_set))], ngram_path,
                  order=NGRAM_ORDER)
    ckpt = last_checkpoint(lm_callback_path)
    return CTCBeamSearchDecoder(
        tokenizer_path=tokenizer_path, beam_size=8, ngram_path=ngram_path,
        ngram_alpha=0.4, ngram_beta=0.6, ngram_offset=NGRAM_OFFSET,
        neural_config_path=None if ckpt is None else __name__,
        neural_checkpoint=ckpt, neural_alpha=0.3, neural_beta=0.3,
        device=device)
