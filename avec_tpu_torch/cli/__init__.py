"""avec_tpu_torch.cli (mirrors avec_tpu/cli): the experiment CLI's
helpers."""
