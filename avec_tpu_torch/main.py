"""The experiment CLI of the port (port of the root main.py; the
reference's main.py): the same flags and modes (training, evaluation, swa,
pass, eval_time) over a port config (`avec_tpu_torch/configs/`, whose
contract the package docstring states):

    python -m avec_tpu_torch.main -c avec_tpu_torch/configs/lrs23_av.py \\
        -m training [--cpu] [-d] [--load_last | -i CHECKPOINT] ...

It runs on the card unless `--cpu` is passed; without `--cpu` and without
CUDA it raises. `-d` joins the default process group
(`parallel/dist.py:init_distributed`) from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the card) or from
`--coordinator host:port --num_processes N --process_id R`, with "nccl" on
cards and "gloo" under `--cpu`, and the trainer takes the data-parallel
step. `--profile` writes a torch.profiler trace of the mode under
callback_path/profile. The trace carries the port's `avec/` spans
(`utils/spans.py`): each train step's phases (`avec/train/step`, `micro`,
`to_device`, `forward`, `loss`, `backward`, `grad_norm`, `optimizer`, and
`all_reduce` / `ema` where they run) and each hand-written kernel call
(`avec/kernel/<name>`). In a trace viewer a gap in the card's lane lies
under the span the host was in, so idle time and the runtime's sync calls
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`,
`cudaMemcpy`) read by phase; a kernel's launch links it to its span. The
kernel routes come from AVEC_TPU_FUSED_FFN,
AVEC_TPU_FUSED_ATT, AVEC_TPU_FUSED_CONV and AVEC_TPU_STEM, read when the
config builds its model.

`main(argv)` runs the CLI in-process on a list of arguments and returns
them parsed, with the config's setup.
"""

import argparse
import os

import torch

MODES = ("training", "evaluation", "swa", "pass", "eval_time")


def parser() -> argparse.ArgumentParser:
    """The root main.py's flags (main.py:127-178)."""
    p = argparse.ArgumentParser(prog="python -m avec_tpu_torch.main")
    p.add_argument("-c", "--config_file", type=str,
                   default="avec_tpu_torch/configs/lrs23_av.py",
                   help="Port config: a file path or a dotted module name")
    p.add_argument("-m", "--mode", type=str, default="training",
                   help="Mode : training, evaluation, swa, pass, eval_time")
    p.add_argument("-i", "--checkpoint", type=str, default=None,
                   help="Load model from checkpoint name")
    p.add_argument("-j", "--num_workers", type=int, default=0,
                   help="Number of data loading workers")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    p.add_argument("--load_last", action="store_true",
                   help="Load last model checkpoint")

    p.add_argument("-d", "--distributed", action="store_true",
                   help="Data-parallel run over a torch.distributed group")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Rendezvous address host:port")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_log", action="store_true",
                   help="Log every rank instead of only rank 0")

    p.add_argument("--epochs", type=int, default=None,
                   help="Override config epochs")
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--saving_period_step", type=int, default=None)
    p.add_argument("--saving_period_epoch", type=int, default=1)
    p.add_argument("--step_log_period", type=int, default=100)
    p.add_argument("--no_eval_training", action="store_true")

    p.add_argument("--eval_period_epoch", type=int, default=1)
    p.add_argument("--eval_period_step", type=int, default=None)
    p.add_argument("--batch_size_eval", type=int, default=None)
    p.add_argument("--verbose_eval", type=int, default=0)
    p.add_argument("--eval_steps", type=int, default=None)

    p.add_argument("--show_dict", action="store_true")
    p.add_argument("--show_modules", action="store_true")

    p.add_argument("--swa_epochs", nargs="+", default=None)
    p.add_argument("--swa_epochs_list", nargs="+", default=None)
    p.add_argument("--swa_type", type=str, default="equal")

    p.add_argument("--detect_anomaly", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace under callback_path")
    return p


def _join_group(args) -> str:
    """Join the default process group; returns this rank's device."""
    from avec_tpu_torch.parallel.dist import init_distributed

    backend = "gloo" if args.cpu else "nccl"
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env and args.num_processes is None:
        world, rank, init_method = (int(env["WORLD_SIZE"]), int(env["RANK"]),
                                    "env://")
        local = int(env.get("LOCAL_RANK", rank))
    else:
        if not (args.coordinator and args.num_processes
                and args.process_id is not None):
            raise ValueError("-d needs torchrun's environment or "
                             "--coordinator, --num_processes and "
                             "--process_id")
        addr = args.coordinator
        init_method = addr if "://" in addr else f"tcp://{addr}"
        world, rank = args.num_processes, args.process_id
        local = rank
    if args.cpu:
        device = "cpu"
    else:
        device = f"cuda:{local % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    init_distributed(backend, world, rank, init_method)
    return device


def run(args):
    """main.py:37-124 on parsed arguments; returns them, with the config's
    `setup` among them."""
    from avec_tpu_torch.cli import functions
    from avec_tpu_torch.decode.beam import import_config
    from avec_tpu_torch.models.zoo import resolve_device
    from avec_tpu_torch.parallel import dist as pdist

    if args.mode not in MODES:
        raise ValueError(f"mode {args.mode!r}: one of {MODES}")
    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.distributed:
        device = _join_group(args)
    args.device = device
    args.rank = pdist.rank()
    if args.rank == 0:
        print(f"Mode: {args.mode}")

    args.config = import_config(args.config_file)
    trainer = functions.load_model(args)
    dataset_train, dataset_eval = functions.load_datasets(args)
    setting = lambda name, default=None: functions.setting(args, name,  # noqa
                                                           default)
    precision = setting("precision")
    if args.checkpoint_path:
        trainer.load(args.checkpoint_path)

    profiler = None
    if args.profile:
        trace_dir = os.path.join(args.callback_path, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        print(f"Profiling to {trace_dir}")

    # a setup's eval_training, else the flag's (main.py:102-103)
    args.eval_training = setting("eval_training", not args.no_eval_training)
    eval_steps = setting("eval_steps", args.eval_steps)
    recompute = setting("recompute_metrics", False)
    if args.mode == "training":
        trainer.fit(
            dataset_train,
            epochs=(args.epochs if args.epochs is not None
                    else setting("epochs", 1000)),
            dataset_eval=dataset_eval, eval_steps=eval_steps,
            verbose_eval=args.verbose_eval,
            initial_epoch=(int(args.checkpoint.split("_")[2])
                           if args.checkpoint is not None else 0),
            callback_path=args.callback_path,
            steps_per_epoch=args.steps_per_epoch, precision=precision,
            accumulated_steps=setting("accumulated_steps", 1),
            eval_period_step=setting("eval_period_step",
                                     args.eval_period_step),
            eval_period_epoch=setting("eval_period_epoch",
                                      args.eval_period_epoch),
            saving_period_step=setting("saving_period_step",
                                       args.saving_period_step),
            saving_period_epoch=setting("saving_period_epoch",
                                        args.saving_period_epoch),
            step_log_period=args.step_log_period,
            eval_training=args.eval_training,
            dist_log=args.dist_log,
            grad_init_scale=setting("grad_init_scale"),
            detect_anomaly=setting("detect_anomaly", args.detect_anomaly),
            recompute_metrics=recompute)
    elif args.mode == "evaluation":
        trainer._evaluate(dataset_eval, eval_steps, args.verbose_eval,
                          recompute)
    elif args.mode == "swa":
        trainer.swa(dataset_train, callback_path=args.callback_path,
                    start_epoch=(args.swa_epochs[0] if args.swa_epochs
                                 else None),
                    end_epoch=args.swa_epochs[1] if args.swa_epochs else None,
                    epochs_list=args.swa_epochs_list,
                    update_steps=args.steps_per_epoch,
                    swa_type=args.swa_type, precision=precision)
    elif args.mode == "eval_time":
        eval_time = trainer.eval_time(
            dataset_eval[0] if isinstance(dataset_eval, list)
            else dataset_eval, eval_steps=eval_steps)
        if args.rank == 0:
            print(f"Eval time: {eval_time}")

    if profiler is not None:
        profiler.stop()
        path = os.path.join(args.callback_path, "profile",
                            f"trace_rank{args.rank}.json")
        profiler.export_chrome_trace(path)
        if args.rank == 0:
            print(f"Profile trace: {path}")
    return args


def main(argv=None):
    """Run the CLI on `argv` (default: sys.argv[1:]) and return the parsed
    arguments, the config's `setup` (its trainer, datasets) among them.
    Under -d the process group is left when the mode ends."""
    args = parser().parse_args(argv)
    try:
        return run(args)
    finally:
        if args.distributed and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
