"""avec_tpu_torch.data (mirrors avec_tpu/data): datasets, collation, the
synthetic sets and the loader, in numpy."""
