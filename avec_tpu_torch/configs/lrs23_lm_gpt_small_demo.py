"""The LRS23 GPT-Small config of the demo (configs/LRS23/LM/
GPT-Small-demo.py): `lrs23_lm_gpt_small` with no pretrained load (:17) and
the tokenizer under media/ (:26); the same rescorer contract."""

from avec_tpu_torch.configs import common, lrs23_lm_gpt_small as base
from avec_tpu_torch.configs.lrs23_lm_gpt_small import (  # noqa: F401
    accumulated_steps, batch_size, eos_token, epochs, label_max_length, lr,
    max_pos_encoding, model, pad_token, precision, pretrained_checkpoint,
    sos_token, vocab_size)

pretrained = False                                       # GPT-Small-demo.py:17
tokenizer_path = "media/tokenizerbpe1024.json"           # :26
tokenizer = tokenizer_path
callback_path = base.callback_path
build_model = base.build_model


def build(callback_path: str = callback_path, device="cuda",
          data_parallel: bool = False, seed: int = 0) -> common.Setup:
    """`lrs23_lm_gpt_small.build` without the pretrained load and with the
    demo's tokenizer."""
    return base.build(callback_path, device, data_parallel, seed,
                      pretrained=pretrained, tokenizer_path=tokenizer_path)
