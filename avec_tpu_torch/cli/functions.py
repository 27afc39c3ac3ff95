"""The CLI's helpers: building a config's setup, its loaders, checkpoint
discovery (port of avec_tpu/cli/functions.py:31-123; the reference's
functions.py).

One process drives one device. Under `-d` every process is a rank of the
default `torch.distributed` group: its training loader gives it its own
part of each global batch (`num_replicas` / `rank` from the group, the
DistributedSampler's strided shards), so the global batch is the dataset's
batch size times the data-parallel degree, as in the JAX CLI, and the
trainer takes those parts as they are. The evaluation loaders are not
sharded: every rank evaluates the whole set, as the trainer's `evaluate`
does.
"""

import contextlib
import os
import socket

from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.parallel import dist as pdist
from avec_tpu_torch.train.checkpoint import find_last_checkpoint


def setting(args, name: str, default=None):
    """A setup's engine setting (a JAX config's global), or `default` when
    the setup has none or holds None."""
    value = getattr(args.setup, name, None)
    return default if value is None else value


def default_callback_path(config_file: str) -> str:
    """"callbacks/" + the config's path under its first directory, without
    ".py" (functions.py:44-47)."""
    return os.path.join("callbacks", "/".join(
        config_file.replace(".py", "").split("/")[1:]))


def load_model(args):
    """Build the config's setup on `args.device` and return its trainer
    (functions.py:31-61): EMA from the setup's `ema_tau`, the callback path,
    `--load_last` (the largest-step checkpoint of either format in the
    callback path), the checkpoint's path for main() to load, and the
    summary on rank 0."""
    config = args.config
    callback_path = getattr(config, "callback_path",
                            default_callback_path(args.config_file))
    args.setup = config.build(callback_path=callback_path,
                              device=args.device,
                              data_parallel=args.distributed)
    trainer = args.setup.trainer
    args.callback_path = getattr(args.setup, "callback_path", callback_path)
    if args.rank == 0:
        print(f"Rank {args.rank} device: {trainer.device}")
    ema_tau = setting(args, "ema_tau")
    if ema_tau:
        trainer.set_ema(ema_tau)

    if args.load_last:
        last = find_last_checkpoint(args.callback_path)
        if last is not None:
            args.checkpoint = last
    args.checkpoint_path = (os.path.join(args.callback_path, args.checkpoint)
                            if args.checkpoint is not None else None)
    if args.rank == 0:
        trainer.summary(show_dict=args.show_dict,
                        show_modules=args.show_modules)
    return trainer


def _make_loader(dataset, args, drop_last: bool) -> DataLoader:
    """functions.py:64-84: a training loader (drop_last) sharded over the
    ranks, packing `accumulated_steps` micro-batches per collate, length
    bucketed where the dataset knows its lengths; an evaluation loader in
    the dataset's order over the whole set."""
    world, rank = (pdist.world_size(), pdist.rank()) if drop_last else (1, 0)
    accum = setting(args, "accumulated_steps", 1) if drop_last else 1
    return DataLoader(
        dataset, batch_size=dataset.batch_size,
        collate_fn=dataset.collate_fn, drop_last=drop_last,
        num_replicas=world, rank=rank, accum=accum,
        num_workers=args.num_workers,
        bucket_by_length=drop_last and setting(args, "bucket_by_length",
                                               True))


def load_datasets(args):
    """functions.py:87-116: the setup's training set and evaluation set (or
    list of sets) as loaders."""
    setup = args.setup
    dataset_train = None
    if getattr(setup, "training_dataset", None) is not None:
        dataset_train = _make_loader(setup.training_dataset, args,
                                     drop_last=True)
        if args.rank == 0:
            ds = dataset_train.dataset
            print(f"Training Dataset: {ds.__class__.__name__}, "
                  f"{len(ds):,} samples - {len(dataset_train):,} batches - "
                  f"batch size {dataset_train.batch_size}")

    dataset_eval = None
    evaluation = getattr(setup, "evaluation_dataset", None)
    if evaluation is not None:
        sets = evaluation if isinstance(evaluation, list) else [evaluation]
        loaders = [_make_loader(d, args, drop_last=False) for d in sets]
        if args.rank == 0:
            for dl in loaders:
                print(f"Evaluation Dataset: {dl.dataset.__class__.__name__}, "
                      f"{len(dl.dataset):,} samples - {len(dl):,} batches")
        dataset_eval = loaders if isinstance(evaluation, list) else loaders[0]
    return dataset_train, dataset_eval


def get_open_port() -> int:
    """A free TCP port on this host (functions.py:119-123)."""
    with contextlib.closing(socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)) as s:
        s.bind(("", 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]
