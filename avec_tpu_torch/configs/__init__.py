"""Training setups of the port, each citing the config it follows.

The contract between a config and the CLI (`python -m avec_tpu_torch.main
-c <config> -m <mode>`): a config module does no work when it is
imported. It defines

  * `build(callback_path=..., device=..., data_parallel=False) -> Setup`,
    which makes the model, its `Trainer` (built data-parallel when asked:
    the process group is up by then), the decoder and the datasets;
  * optionally a module-level `callback_path`, the JAX config's (without
    one the CLI uses "callbacks/" + the config's path under its first
    directory, as the JAX main.py does).

The CLI reads from the Setup `trainer`, `training_dataset` and
`evaluation_dataset` (a `data.dataset.Dataset` carrying its batch size and
collate function, or a list of them; the CLI wraps each in a `DataLoader`),
and, where present and not None, the engine settings a JAX config holds as
globals: `precision`, `accumulated_steps`, `epochs`, `eval_training`,
`recompute_metrics`, `eval_steps`, `eval_period_step`, `eval_period_epoch`,
`saving_period_step`, `saving_period_epoch`, `grad_init_scale`,
`detect_anomaly`, `ema_tau` and `bucket_by_length`. `common.Setup` is the
LRS2/3 and LibriSpeech configs' Setup; the tone and LRW configs' own Setups
give their sets under the same names.

The kernel routes are not a config's: the models read AVEC_TPU_FUSED_FFN,
AVEC_TPU_FUSED_ATT, AVEC_TPU_FUSED_CONV and AVEC_TPU_STEM when they are
built, as the JAX package's do.
"""
