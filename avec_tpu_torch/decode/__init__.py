"""avec_tpu_torch.decode (mirrors avec_tpu/decode)."""
