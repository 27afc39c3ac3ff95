"""Data parallelism over `torch.distributed` (port of avec_tpu/parallel)."""
