"""avec_tpu_torch.models (mirrors avec_tpu/models)."""
