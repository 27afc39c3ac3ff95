"""avec_tpu_torch.utils (mirrors avec_tpu/utils): WER and the tokenizer."""
