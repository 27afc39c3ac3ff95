"""avec_tpu_torch.ops (mirrors avec_tpu/ops)."""
