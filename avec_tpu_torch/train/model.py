"""The training engine of the task models (port of avec_tpu/train/model.py:
173-306, 324-345, 375-558, 580-1113).

A batch is {"inputs": ..., "targets": ...} of numpy arrays or tensors: the
inputs a list of the model's positional arguments (or one array), e.g. for
the AV model [video (B, Tv, 88, 88, 1), video_len (B,), audio (B, Ta),
audio_len (B,)], and the targets, e.g. (labels (B, U), label_len (B,)) for
the CTC models or labels (B,) for the LRW classifier. One step
(`train_step`) runs the model in training
mode, the weighted losses of the outputs, the backward, the global
gradient norm (clipping only when `grad_max_norm` is set), the optimizer
(by default Adam with L2 in the gradient under the Noam schedule), the step
counter and, with `set_ema`, the EMA update; it returns (losses, infos) with
`lr` and `grad_norm`, and where `eval_training` is set (`fit` sets it from
its argument) the device metrics of the training outputs (a classifier's
accuracy) in infos["metrics"].
Activations run in `precision` on fp32 parameters.
`accumulated_steps=A` splits the batch into A micro-batches in order: their
gradients, losses and metrics are summed, then divided by A. Every
micro-batch draws its own dropout masks and kernel seeds from the model's
generators.
While a profiler records, a step marks its phases with the `avec/train/*`
spans of `utils/spans.py` (step, micro-batch, to_device, forward, loss,
backward, all_reduce, grad_norm, optimizer, ema).

`fit` runs epochs over a `DataLoader` with periodic evaluation and
checkpoints, summing the losses on the device and reading them only at log
periods and at the end of an epoch; with a `callback_path` it logs the
step, epoch and evaluation scalars to TensorBoard's `SummaryWriter` under
`callback_path/logs` where it imports, else to `utils/logging.py:
JsonlWriter` (events.jsonl), and logs an exception as text before raising
it again. `evaluate` runs the eval-mode forward, the losses, the decoders'
device part and the host metrics, one batch ahead of the host. `save` /
`load` use the reference's torch format (`train/checkpoint.py`); `load`
also reads the JAX package's msgpack checkpoints, their Adam moments
included. `swa` averages the end-of-epoch checkpoints of the epochs listed
and re-estimates the BatchNorm statistics. `save_logits` pickles the
eval-mode outputs and the targets per batch; `generate` is the generation
loop of a model that defines `forward_generate`; `summary`, `show_dict` and
`num_params` describe the model.

`Trainer(data_parallel=True)` is the data-parallel step (the JAX package's
step on a batch sharded over the mesh's 'data' axis; the reference's DDP with
SyncBatchNorm): every rank of an initialized process group passes its own
part of the global batch, as the JAX package's hosts pass their local
batches (the CLI's loaders shard by rank; `parallel.dist.shard_batch` cuts
an already padded global batch), split into micro-batches as it is;
the model runs with sync-BN and the kernels' DP forms
(`set_data_parallel`), and one flat all-reduce sums the rank-weighted
gradients and losses, so every rank holds the gradient and losses of the
global batch and takes the same Adam step. Rank 0 prints and writes the
checkpoints. Under data parallelism `fit` passes every training batch
through `parallel.dist.host_local_batch_to_global` (model.py:655): the
ranks' batches are padded to one shape, so a rank-sharded loader of ragged
utterances gives the one-process step on the global batch. Evaluation
differs from the JAX CLI's, which shards the evaluation loader and
assembles each batch (model.py:807, 1022, 1075): here every rank evaluates
the whole set, every batch whole (the CLI gives each rank the whole
evaluation loader), so a last partial batch needs no gather and every rank
holds the one-process losses and metrics.

`Trainer(model_parallel=mp, param_sharding_rules=rules)` is the
tensor-parallel case (model.py:128-133, 262-271): the ranks form the
(world // mp, mp) mesh of `parallel.dist.make_mesh`, the parameters that
`rules` match (e.g. `gpt_tensor_parallel_rules()`) hold only their shards
(`parallel.tensor_parallel.shard_module`) and the model's forwards place
the collectives. Gradients are all-reduced over the data group only; the
global gradient norm sums the sharded gradients' squares over the model
group and counts each replicated parameter once; the optimizer's moments
and the EMA are sharded like their parameters; `save` gathers the shards
into the file a one-rank run writes, and `load` shards what it reads.
With data_parallel=True as well it is the 2-D case; without it the world
size must equal mp. Every rank of a model group passes the same batch. At
mp 1 the rules shard nothing (a model axis of one rank holds every
parameter whole, as in the JAX package).
"""

import glob
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avec_tpu_torch.ops.module_utils import (clear_records,
                                             harvest_aux_losses,
                                             harvest_infos)
from avec_tpu_torch.models.zoo import (  # noqa: F401 (AV_LOSS_WEIGHTS)
    AV_LOSS_WEIGHTS, AudioVisualEfficientConformerInterCTC, Classifier,
    resolve_device)
from avec_tpu_torch.parallel import tensor_parallel as tp
from avec_tpu_torch.parallel.dist import (assemble_batch, make_mesh,
                                          padding_values, shard_like_params,
                                          sync_global_devices)
from avec_tpu_torch.train.checkpoint import (load_checkpoint, restore_tree,
                                             save_checkpoint)
from avec_tpu_torch.train.losses import loss_dict, rank_weight
from avec_tpu_torch.train.metrics import metric_dict
from avec_tpu_torch.train.optim import Optimizer, noam_adam, optim_dict
from avec_tpu_torch.train.schedulers import as_scheduler
from avec_tpu_torch.utils.spans import span

# model.py:53-59: float16 configs run in bf16, which needs no loss scaler
_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.bfloat16, "fp16": torch.bfloat16}


def resolve_precision(precision) -> torch.dtype:
    """A precision name or dtype -> the activation dtype (model.py:62-73):
    None is fp32, float16 runs as bf16."""
    if precision is None:
        return torch.float32
    if isinstance(precision, torch.dtype):
        return torch.bfloat16 if precision == torch.float16 else precision
    return _DTYPES[str(precision)]


def _per_output(struct, keys) -> Dict[str, Any]:
    """A spec conformed to the output names `keys` as the JAX
    `map_to_outputs` does (model.py:212-227): a dict keeps its keys (each
    must be an output), the i-th entry of a list goes to keys[i], anything
    else applies to every output; None entries are left out."""
    if struct is None:
        return {}
    if isinstance(struct, dict):
        unknown = [k for k in struct if k not in keys]
        if unknown:
            raise KeyError(f"unknown output names {unknown}; the outputs are "
                           f"{list(keys)}")
        return {k: struct[k] for k in keys if struct.get(k) is not None}
    if isinstance(struct, list):
        return {k: struct[i] for i, k in enumerate(keys)
                if i < len(struct) and struct[i] is not None}
    return {k: struct for k in keys}


def _by_output(struct, outputs) -> Dict[str, Any]:
    """`_per_output` over the names of `outputs` sorted, the order in which
    the JAX engine sees them (`jax.eval_shape` returns a dict's keys
    sorted, model.py:242-252), so a list's i-th entry goes to the i-th name
    in sorted order; the result is in the outputs' own order."""
    mapped = _per_output(struct, sorted(outputs))
    return {k: mapped[k] for k in outputs if k in mapped}


def _as_list(spec) -> list:
    return spec if isinstance(spec, list) else [spec]


def _metric_names(metrics: Dict[str, list]) -> Dict[Tuple[str, int], str]:
    """The name of the i-th metric of each output, as the JAX engine names
    them (model.py:425-439, :843-857): over the output names in sorted
    order, a metric takes its own name the first time and
    "<name>_<output>" after that; one WER object on several outputs is
    "wer" on the first output name in sorted order."""
    names: Dict[Tuple[str, int], str] = {}
    for key in sorted(metrics):
        for i, metric in enumerate(metrics[key]):
            taken = set(names.values())
            names[key, i] = (metric.name if metric.name not in taken
                             else f"{metric.name}_{key}")
    return names


def _loss_weights(spec):
    """Loss weights as the JAX `compile` takes them (model.py:182-192):
    None weighs every output 1, a number weighs every output alike, a dict
    or a list (a tuple is taken as a list) holds a number or a step
    scheduler per output."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: as_scheduler(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [as_scheduler(v) for v in spec]
    return as_scheduler(spec)


def _to(struct, device):
    """Arrays in a list, tuple or dict (or one array) -> tensors on
    `device`, the container kept."""
    if isinstance(struct, dict):
        return {k: _to(v, device) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(_to(v, device) for v in struct)
    return torch.as_tensor(struct).to(device)


def _detach(struct):
    """Tensors of a dict / list / tuple of outputs, detached."""
    if isinstance(struct, dict):
        return {k: _detach(v) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(_detach(v) for v in struct)
    return struct.detach() if isinstance(struct, torch.Tensor) else struct


def _to_numpy(struct):
    """Tensors of a dict / list / tuple -> numpy arrays (bf16 as fp32)."""
    if isinstance(struct, dict):
        return {k: _to_numpy(v) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(_to_numpy(v) for v in struct)
    if isinstance(struct, torch.Tensor):
        t = struct.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return struct


def _split_micro(batch, accum: int) -> List[Any]:
    """(A*B, ...) leaves -> A micro-batches of B rows, in order
    (model.py:724-731)."""
    if accum == 1:
        return [batch]

    def take(a, i):
        if isinstance(a, dict):
            return {k: take(v, i) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(take(v, i) for v in a)
        n = a.shape[0]
        if n % accum:
            raise ValueError(f"a batch of {n} does not split into "
                             f"{accum} micro-batches")
        m = n // accum
        return a[i * m:(i + 1) * m]

    return [take(batch, i) for i in range(accum)]


class Trainer:
    """Owns the model in training mode, its losses, optimizer, step counter
    and optional EMA, and the loops over data.

    `model` is any zoo model (`models/zoo.py`); without one, model_kwargs
    go to AudioVisualEfficientConformerInterCTC (defaults: the reference
    depth, vocab 256). `loss`, `loss_weights`, `metrics` and `decoders` are
    per output as the JAX `compile` takes them: a dict by output name, a
    list mapped onto the output names sorted (as `jax.eval_shape` returns
    them: AO-Tone's [0.25, 0.25, 0.5] puts 0.5 on "outputs", the last of
    "ctc_1", "ctc_3", "outputs"), or one object for every output; an output
    without a loss adds none, one without a weight weighs 1, and a dict of
    weights may name outputs that the model's depth does not have (the
    reference's AV weights on a shallower AV model). `loss`,
    `loss_weights` and `metrics="default"` left out take the model's
    `compile_defaults` (e.g. CTC and [0.125] * 4 + [0.5] for the AO model,
    cross-entropy and accuracy for the LRW classifier); a weight is a number
    or a step scheduler, and a single number weighs every output.
    `optimizer` is a function of the model that returns an `Optimizer`
    (`train.optim.Adam(...)`, `AdamW(...)`; default: the model's
    `compile_defaults` optimizer, else `noam_adam`). Metrics on decoded
    strings (`on_host`) need a decoder of the output; the accuracy metrics
    (not `on_host`) run on a classifier's outputs on the device. Targets
    map onto the outputs as `metrics` do: a tuple or one array goes to
    every output.
    It runs on the card unless the caller passes device="cpu".

    `loss`, `metrics`, `optimizer` and `decoders` may also be registry names,
    as the JAX `compile` takes them (model.py:174-197): `loss_dict[name]()`,
    `metric_dict[name]()`, `decoders.decoder_dict[name]()`, and
    `optim_dict[name](lr=0.001)`, except the name of the model's own default
    optimizer (the zoo models' "Adam", the GPT's "AdamW"), which takes that
    default, as the JAX models' `compile` does.

    data_parallel=True needs the default `torch.distributed` process group
    (`avec_tpu_torch.parallel.dist.init_distributed`), over whose ranks the
    step runs. Rank 0's parameters and statistics are broadcast to the others
    at construction. Every rank passes its own part of the global batch."""

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 device="cuda", precision: str = "bfloat16", seed: int = 0,
                 loss=None, loss_weights=None,
                 grad_max_norm: Optional[float] = None,
                 data_parallel: bool = False,
                 optimizer: Optional[Callable[..., Optimizer]] = None,
                 metrics="default", decoders=None, model_parallel: int = 1,
                 param_sharding_rules=None, **model_kwargs):
        self.device = resolve_device(device)
        self.dtype = resolve_precision(precision)
        if model is None:
            model = AudioVisualEfficientConformerInterCTC(
                device=self.device,
                generator=torch.Generator().manual_seed(seed), **model_kwargs)
        self.model = model.train()
        self.model.set_generators(seed)
        defaults = self.model.compile_defaults()
        if isinstance(loss, str):
            loss = loss_dict[loss]()
        self.loss = loss if loss is not None else defaults["loss"]
        self.loss_weights = _loss_weights(
            loss_weights if loss_weights is not None
            else defaults["loss_weights"])
        if isinstance(optimizer, str):
            optimizer = (defaults.get("optimizer", noam_adam)
                         if optimizer == defaults.get("optimizer_name",
                                                      "Adam")
                         else optim_dict[optimizer](lr=0.001))
        if isinstance(metrics, str):
            metrics = (defaults["metrics"] if metrics == "default"
                       else metric_dict[metrics]())
        if isinstance(decoders, str):
            from avec_tpu_torch.decode import decoder_dict

            decoders = decoder_dict[decoders]()
        specs = (metrics.values() if isinstance(metrics, dict) else
                 metrics if isinstance(metrics, list) else [metrics])
        if not isinstance(self.model, Classifier) and any(
                not getattr(m, "on_host", False) for spec in specs
                if spec is not None for m in _as_list(spec)):
            raise ValueError("a CTC model's outputs are (logits, lengths) "
                             "pairs: its metrics are those of decoded "
                             "strings (on_host); the accuracy metrics run "
                             "on a classifier's outputs")
        self.metrics = metrics
        self.decoders = decoders
        self.grad_max_norm = grad_max_norm
        self.step = 0
        self.ema_tau = 0.0
        self.ema_state: Optional[Dict[str, torch.Tensor]] = None
        self.group = None
        self.mesh = None
        self.rank = 0
        self.eval_training = False
        self._dist_log = False
        if data_parallel or model_parallel > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"data_parallel={data_parallel}, model_parallel="
                    f"{model_parallel} needs an initialized process group: "
                    "call avec_tpu_torch.parallel.dist.init_distributed "
                    "first")
            self.mesh = make_mesh(model_parallel)
            self.rank = dist.get_rank()
            if data_parallel:
                self.group = (self.mesh.data if self.mesh.data is not None
                              else dist.group.WORLD if model_parallel == 1
                              else None)
            elif self.mesh.data_size > 1:
                raise ValueError(
                    f"model_parallel={model_parallel} over "
                    f"{dist.get_world_size()} ranks leaves a data axis of "
                    f"{self.mesh.data_size}: pass data_parallel=True")
            if self.group is not None:
                self.model.set_data_parallel(self.group)
            self._broadcast_state()
            if (param_sharding_rules is not None
                    and self.mesh.model is not None):
                tp.shard_module(self.model, self.mesh, param_sharding_rules)
        self.optimizer = (optimizer or defaults.get("optimizer", noam_adam))(
            self.model)

    # ------------------------------------------------------------- state
    def set_ema(self, ema_tau: float) -> None:
        """Keep an exponential moving average of the parameters: after each
        step e = tau * e + (1 - tau) * p, and the EMA's buffers are copies of
        the live ones (model.py:545-553). It starts from the current state;
        tau = 0 drops it."""
        self.ema_tau = float(ema_tau)
        self.ema_state = None
        if self.ema_tau:
            live = self.model.state_dict(keep_vars=True)
            self.ema_state = {k: v.detach().clone() for k, v in live.items()}
            params = dict(self.model.named_parameters())
            # (EMA, live) tensor lists: parameters, then buffers
            self._ema_pairs = tuple(
                ([self.ema_state[k] for k in live if (k in params) == is_p],
                 [live[k].detach() for k in live if (k in params) == is_p])
                for is_p in (True, False))

    def _update_ema(self) -> None:
        (ema_p, live_p), (ema_b, live_b) = self._ema_pairs
        torch._foreach_mul_(ema_p, self.ema_tau)
        torch._foreach_add_(ema_p, live_p, alpha=1.0 - self.ema_tau)
        for e, b in zip(ema_b, live_b):
            e.copy_(b)

    def _broadcast_state(self) -> None:
        """Rank 0's parameters and buffers on every rank, in one broadcast
        (before any sharding)."""
        state = list(self.model.parameters()) + list(self.model.buffers())
        flat = torch.cat([t.detach().reshape(-1).float() for t in state])
        dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, v in zip(state, flat.split([t.numel() for t in state])):
                t.copy_(v.view_as(t))

    def _all_reduce(self, losses: Dict[str, torch.Tensor],
                    replicated: bool = False) -> Dict[str, torch.Tensor]:
        """The global batch's gradients (into every .grad) and losses: each
        rank's weighted by `rank_weight` and summed in one all-reduce over
        the data group. Where every rank holds the whole batch
        (`replicated`, the gather branch of `host_local_batch_to_global`)
        each rank's share is 1 / world whatever the reduction."""
        world = dist.get_world_size(self.group)
        weight = (1.0 / world if replicated else
                  rank_weight(getattr(self.loss, "reduction", "mean"), world))
        params = list(self.model.parameters())
        keys = list(losses)
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [torch.stack([losses[k] for k in keys])])
        flat.mul_(weight)
        dist.all_reduce(flat, group=self.group)
        sizes = [p.numel() for p in params] + [len(keys)]
        *grads, reduced = flat.split(sizes)
        for p, g in zip(params, grads):
            p.grad.copy_(g.view_as(p))
        return dict(zip(keys, reduced.clone()))

    def _to_device(self, batch) -> Tuple[list, tuple]:
        raw = batch["inputs"]
        inputs = []
        for a in (raw if isinstance(raw, (list, tuple)) else [raw]):
            t = torch.as_tensor(a).to(self.device)
            inputs.append(t.to(self.dtype) if t.is_floating_point() else t)
        return inputs, _to(batch["targets"], self.device)

    # ------------------------------------------------------------- steps
    def compute_losses(self, outputs, targets, step: int
                       ) -> Dict[str, torch.Tensor]:
        """Per-output losses and their weighted total, the weights called at
        step + 1 (model.py:375-423), each output against its targets."""
        losses = {}
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_of = _by_output(self.loss, outputs)
        weights = self.loss_weights
        weight_of = ({k: w for k, w in weights.items() if k in outputs}
                     if isinstance(weights, dict)
                     else _by_output(weights, outputs))
        target_of = _by_output(targets, outputs)
        for key, out in outputs.items():
            if key not in loss_of:
                continue
            loss = loss_of[key](target_of[key], out)
            losses["loss_" + key] = loss
            weight = weight_of.get(key)
            total = total + loss * (weight(step + 1) if weight else 1.0)
        if len(losses) > 1:
            return {"loss": total, **losses}
        return {"loss": total}

    def device_metrics(self, outputs, targets) -> Dict[str, torch.Tensor]:
        """The metrics of the device's outputs (a classifier's accuracy; not
        those of decoded strings), named as the JAX engine names them
        (model.py:425-439), as device scalars."""
        metrics = _by_output(self.metrics, outputs)
        target_of = _by_output(targets, outputs)
        on_device = {key: [m for m in _as_list(spec)
                           if not getattr(m, "on_host", False)]
                     for key, spec in metrics.items()}
        names = _metric_names(on_device)
        return {names[key, i]: metric(target_of[key], outputs[key])
                for key, ms in on_device.items()
                for i, metric in enumerate(ms)}

    def _forward_backward(self, batch, accumulated_steps: int = 1,
                          metrics: Optional[Dict[str, torch.Tensor]] = None,
                          module_infos: Optional[Dict[str, torch.Tensor]]
                          = None, replicated: bool = False
                          ) -> Dict[str, torch.Tensor]:
        """The gradients (into .grad) and losses of a batch, summed over its
        micro-batches and divided by their count (model.py:478-527), of the
        global batch in data-parallel mode. The auxiliary losses that the
        model's modules record (`ops/module_utils.py`) join each
        micro-batch's total with their weights and are reported as
        `loss_<name>` (model.py:466-472); the records are cleared around
        every forward. With a `metrics` dict, the device metrics of the
        detached outputs are averaged into it the same way
        (`eval_training`, model.py:473-475), and with a `module_infos`
        dict the modules' infos."""
        self.model.train()
        self.optimizer.optimizer.zero_grad(set_to_none=True)
        total: Dict[str, torch.Tensor] = {}
        for micro in _split_micro(batch, accumulated_steps):
            with span("avec/train/micro"):
                with span("avec/train/to_device"):
                    inputs, targets = self._to_device(micro)
                clear_records(self.model)
                with span("avec/train/forward"):
                    outputs = self.model(*inputs)
                with span("avec/train/loss"):
                    losses = self.compute_losses(outputs, targets, self.step)
                    aux = harvest_aux_losses(self.model)
                    for name, (value, weight) in aux.items():
                        losses["loss_" + name] = value
                        losses["loss"] = losses["loss"] + weight * value
                if module_infos is not None:
                    for k, v in harvest_infos(self.model).items():
                        v = torch.as_tensor(v).detach() / accumulated_steps
                        module_infos[k] = (module_infos[k] + v
                                           if k in module_infos else v)
                clear_records(self.model)
                with span("avec/train/backward"):
                    losses["loss"].backward()
                for k, v in losses.items():
                    total[k] = (total[k] + v.detach() if k in total
                                else v.detach())
                if metrics is not None:
                    with torch.no_grad():
                        for k, v in self.device_metrics(
                                _detach(outputs), targets).items():
                            metrics[k] = (metrics[k] + v / accumulated_steps
                                          if k in metrics
                                          else v / accumulated_steps)
        params = list(self.model.parameters())
        # A detached conv bias has no gradient; the JAX package gives it an
        # exact zero, which still takes the optimizer's weight decay.
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if accumulated_steps > 1:
            torch._foreach_div_([p.grad for p in params], accumulated_steps)
            total = {k: v / accumulated_steps for k, v in total.items()}
        if self.group is None:
            return total
        with span("avec/train/all_reduce"):
            return self._all_reduce(total, replicated)

    def loss_and_grads(self, batch):
        """One forward + backward without an update: (losses, gradients by
        parameter name), of the global batch in data-parallel mode. The
        running BN statistics do move."""
        losses = self._forward_backward(batch)
        grads = {n: p.grad.detach().clone()
                 for n, p in self.model.named_parameters()}
        return losses, grads

    def train_step(self, batch, accumulated_steps: int = 1,
                   replicated: bool = False):
        """One optimisation step over `accumulated_steps` micro-batches:
        (losses, {"lr", "grad_norm"} and, where `self.eval_training` is set
        (by `fit`), "metrics", and where the model's modules record infos,
        "module_infos"), tensors left on the device. The metrics and infos
        are this rank's. `replicated`: every data rank passes the whole
        global batch (see `_all_reduce`)."""
        with span("avec/train/step"):
            metrics: Optional[Dict[str, torch.Tensor]] = (
                {} if self.eval_training else None)
            module_infos: Dict[str, torch.Tensor] = {}
            losses = self._forward_backward(batch, accumulated_steps, metrics,
                                            module_infos, replicated)
            with span("avec/train/grad_norm"):
                gnorm = self._grad_norm()
                if self.grad_max_norm is not None:
                    # scales by min(1, max_norm / (norm + 1e-6)), as
                    # model.py:531-534
                    torch.nn.utils.clip_grads_with_norm_(
                        self.model.parameters(), self.grad_max_norm, gnorm)
            with span("avec/train/optimizer"):
                lr = self.optimizer.update(self.step)
            self.step += 1
            if self.ema_state is not None:
                with torch.no_grad(), span("avec/train/ema"):
                    self._update_ema()
        infos = {"lr": lr, "grad_norm": gnorm}
        if metrics is not None:
            infos["metrics"] = metrics
        if module_infos:
            infos["module_infos"] = module_infos
        return losses, infos

    def _sharded(self) -> bool:
        return (self.mesh is not None and self.mesh.model is not None
                and bool(tp.sharded_names(self.model)))

    def _grad_norm(self) -> torch.Tensor:
        """The global gradient norm: under tensor parallelism the squares of
        the sharded gradients summed over the model group, each replicated
        parameter's counted once."""
        params = list(self.model.parameters())
        if not self._sharded():
            return torch.nn.utils.get_total_norm([p.grad for p in params])
        split = [p.grad for p in params if tp.tp_dim(p) is not None]
        whole = [p.grad for p in params if tp.tp_dim(p) is None]
        sq = torch.nn.utils.get_total_norm(split) ** 2
        dist.all_reduce(sq, group=self.mesh.model)
        if whole:
            sq = sq + torch.nn.utils.get_total_norm(whole) ** 2
        return sq.sqrt()

    def _saves(self) -> bool:
        """Whether this rank calls `save`: rank 0, or every rank where the
        parameters are sharded (save gathers them)."""
        return self.rank == 0 or self._sharded()

    # --------------------------------------------------------------- fit
    def _log(self, *args) -> None:
        if self.rank == 0:
            print(*args, flush=True)

    def _checkpoint_name(self, callback_path: str, epoch: int) -> str:
        return os.path.join(callback_path, f"checkpoints_epoch_{epoch}_step_"
                                           f"{self.step}.ckpt")

    def fit(self, dataset_train, epochs: int, dataset_eval=None,
            eval_steps: Optional[int] = None, verbose_eval: int = 0,
            initial_epoch: int = 0, callback_path: Optional[str] = None,
            steps_per_epoch: Optional[int] = None, precision=None,
            accumulated_steps: int = 1,
            eval_period_step: Optional[int] = None,
            eval_period_epoch: Optional[int] = 1,
            saving_period_step: Optional[int] = None,
            saving_period_epoch: Optional[int] = 1,
            log_figure_period_step: Optional[int] = None,
            log_figure_period_epoch: Optional[int] = None,
            step_log_period: int = 10, eval_training: bool = True,
            dist_log: bool = False, grad_init_scale=None,
            detect_anomaly: bool = False, recompute_metrics: bool = False
            ) -> List[Dict[str, Any]]:
        """The training loop (model.py:580-722). Returns one record per
        epoch: {"epoch", "steps", "seconds", "losses" (epoch means),
        "metrics" (the training outputs' device metrics with eval_training),
        "eval": [(losses, metrics)] and, with EMA, "eval_ema"}.

        `precision` (a name or dtype; None keeps the trainer's) sets the
        activation dtype from this fit on. `log_figure_period_*` are
        accepted as the JAX package accepts them (it logs no figure);
        `grad_init_scale` is accepted and ignored (bf16 needs no loss
        scaler, model.py:590-592); `detect_anomaly` runs the fit under
        `torch.autograd.set_detect_anomaly`. `dist_log` logs every rank,
        its tags suffixed "-{rank}", each rank to its own file."""
        del log_figure_period_step, log_figure_period_epoch, grad_init_scale
        if precision is not None:
            self.dtype = resolve_precision(precision)
        self._dist_log = bool(dist_log)
        writer = self._make_writer(callback_path)
        anomaly = torch.is_anomaly_enabled()
        eval_before, self.eval_training = self.eval_training, eval_training
        torch.autograd.set_detect_anomaly(bool(detect_anomaly) or anomaly)
        try:
            return self._fit_loop(
                dataset_train, epochs, dataset_eval, eval_steps, verbose_eval,
                initial_epoch, callback_path, steps_per_epoch,
                accumulated_steps, eval_period_step, eval_period_epoch,
                saving_period_step, saving_period_epoch, step_log_period,
                recompute_metrics, writer)
        except Exception as e:
            # logged, then raised again (model.py:613-624)
            if writer is not None:
                try:
                    writer.add_text("Exceptions", f"Rank: {self.rank}\n{e}",
                                    self.step)
                except Exception:
                    pass
            raise
        finally:
            torch.autograd.set_detect_anomaly(anomaly)
            self.eval_training = eval_before
            if writer is not None:
                writer.close()

    def _fit_loop(self, dataset_train, epochs, dataset_eval, eval_steps,
                  verbose_eval, initial_epoch, callback_path, steps_per_epoch,
                  accumulated_steps, eval_period_step, eval_period_epoch,
                  saving_period_step, saving_period_epoch, step_log_period,
                  recompute_metrics, writer):
        history = []
        for epoch in range(initial_epoch, epochs):
            dataset_train.set_epoch(epoch)
            self._log(f"Epoch {epoch + 1}/{epochs}:")
            sums: Dict[str, torch.Tensor] = {}
            metric_sums: Dict[str, torch.Tensor] = {}
            n_steps = 0
            t_epoch = time.perf_counter()
            batches = iter(dataset_train)
            padding = padding_values(getattr(dataset_train, "collate_fn",
                                             None))
            try:
                for batch in batches:
                    step_kw = {}
                    if self.group is not None:
                        batch, sharded = assemble_batch(batch, self.mesh, 0,
                                                        padding)
                        if not sharded:
                            step_kw["replicated"] = True
                    losses, infos = self.train_step(batch, accumulated_steps,
                                                    **step_kw)
                    metrics = infos.pop("metrics", {})
                    n_steps += 1
                    for k, v in losses.items():
                        sums[k] = sums[k] + v if k in sums else v
                    for k, v in metrics.items():
                        metric_sums[k] = (metric_sums[k] + v
                                          if k in metric_sums else v)
                    if ((self.rank == 0 or writer is not None)
                            and self.step % step_log_period == 0):
                        self._log(self._display(sums, metric_sums, n_steps,
                                                infos))
                        if writer is not None:
                            self._log_scalars(
                                writer, "Training-step", self.step, losses,
                                metrics, {"lr": infos["lr"],
                                          "grad_norm": infos["grad_norm"],
                                          "step": self.step})
                    if (eval_period_step and dataset_eval is not None
                            and self.step % eval_period_step == 0):
                        self._evaluate(dataset_eval, eval_steps, verbose_eval,
                                       recompute_metrics, writer, self.step,
                                       "Evaluation-step")
                    if (saving_period_step and callback_path
                            and self._saves()
                            and self.step % saving_period_step == 0):
                        os.makedirs(callback_path, exist_ok=True)
                        self.save(self._checkpoint_name(callback_path,
                                                        epoch + 1))
                    if steps_per_epoch is not None and \
                            n_steps >= steps_per_epoch:
                        break
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            means = {k: float(v) / max(n_steps, 1) for k, v in sums.items()}
            metric_means = {k: float(v) / max(n_steps, 1)
                            for k, v in metric_sums.items()}
            seconds = time.perf_counter() - t_epoch
            self._log("  " + " - ".join(f"{k}: {v:.4f}" for k, v in
                                        {**means, **metric_means}.items()))
            self._log(f"  epoch time {seconds:.1f}s ({n_steps} steps)")
            if writer is not None:
                self._log_scalars(writer, "Training-epoch", epoch + 1, means,
                                  metric_means, {})
            record = {"epoch": epoch + 1, "steps": n_steps,
                      "seconds": seconds, "losses": means,
                      "metrics": metric_means}
            if (eval_period_epoch and dataset_eval is not None
                    and (epoch + 1) % eval_period_epoch == 0):
                record.update(self._evaluate(
                    dataset_eval, eval_steps, verbose_eval, recompute_metrics,
                    writer, epoch + 1, "Evaluation-epoch"))
            if (saving_period_epoch and callback_path and self._saves()
                    and (epoch + 1) % saving_period_epoch == 0):
                os.makedirs(callback_path, exist_ok=True)
                self.save(self._checkpoint_name(callback_path, epoch + 1))
            history.append(record)
        return history

    def _display(self, sums, metric_sums, n_steps: int, infos) -> str:
        parts = [f"{k}: {float(v) / n_steps:.4f}"
                 for k, v in {**sums, **metric_sums}.items()]
        parts.append(f"lr: {infos['lr']:.2e}")
        parts.append(f"grad_norm: {float(infos['grad_norm']):.4f}")
        parts.append(f"step: {self.step}")
        return "  " + " - ".join(parts)

    # ----------------------------------------------------------- logging
    def _make_writer(self, callback_path: Optional[str]):
        """TensorBoard's SummaryWriter under callback_path/logs where it
        imports, else a JsonlWriter there (model.py:1087-1101); rank 0
        only unless dist_log. AVEC_TPU_LOG_FORMAT=jsonl takes the
        JsonlWriter without trying TensorBoard (whose import can pull in
        TensorFlow: seconds and a GiB of host memory per process)."""
        if not callback_path or (self.rank != 0 and not self._dist_log):
            return None
        logs = os.path.join(callback_path, "logs")
        os.makedirs(logs, exist_ok=True)
        try:
            if os.environ.get("AVEC_TPU_LOG_FORMAT", "") == "jsonl":
                raise ImportError("JSON lines asked for")
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(logs)
        except Exception:
            from avec_tpu_torch.utils.logging import JsonlWriter

            name = (f"events_rank{self.rank}.jsonl" if self._dist_log
                    else "events.jsonl")
            return JsonlWriter(os.path.join(logs, name))

    def _log_scalars(self, writer, tag: str, step, losses, metrics,
                     infos) -> None:
        """model.py:1103-1113: "{tag}/{name}" scalars, "{tag}-{rank}/..."
        with dist_log."""
        if self._dist_log:
            tag = f"{tag}-{self.rank}"
        for k, v in {**losses, **metrics}.items():
            writer.add_scalar(f"{tag}/{k}", float(v), step)
        for k, v in infos.items():
            if isinstance(v, (int, float, torch.Tensor)):
                writer.add_scalar(f"{tag}/{k}", float(v), step)

    # ----------------------------------------------------------- evaluate
    def _evaluate(self, datasets, eval_steps, verbose, recompute_metrics,
                  writer=None, step=None, tag: str = "Evaluation"
                  ) -> Dict[str, list]:
        """Evaluate each dataset, and again with the EMA when there is one
        (model.py:734-757); prints the results on rank 0 and logs them as
        "{tag}/{i}" and "{tag}-ema/{i}" to `writer`."""
        out: Dict[str, list] = {"eval": []}
        runs = [("eval", False)]
        if self.ema_state is not None:
            out["eval_ema"] = []
            runs.append(("eval_ema", True))
        for i, ds in enumerate(datasets if isinstance(datasets, list)
                               else [datasets]):
            for key, use_ema in runs:
                losses, metrics = self.evaluate(ds, eval_steps, verbose,
                                                recompute_metrics,
                                                use_ema=use_ema)
                out[key].append((losses, metrics))
                prefix = "ema eval" if use_ema else "eval"
                for k, v in {**losses, **metrics}.items():
                    self._log(f"{prefix} {k}: {v:.4f}")
                if writer is not None and self.rank == 0:
                    self._log_scalars(writer, f"{tag}-ema/{i}" if use_ema
                                      else f"{tag}/{i}", step, losses,
                                      metrics, {})
        return out

    def _eval_forward(self, inputs, use_ema: bool):
        if use_ema:
            return torch.func.functional_call(self.model, self.ema_state,
                                              tuple(inputs))
        return self.model(*inputs)

    def evaluate(self, dataset_eval, eval_steps: Optional[int] = None,
                 verbose: int = 0, recompute_metrics: bool = False,
                 use_ema: bool = False, return_transcripts: bool = False):
        """(mean losses, metrics) over the batches of `dataset_eval`
        (model.py:759-838), and the gathered {metric: (truths, preds)} with
        return_transcripts. The metrics of decoded strings are taken per
        batch and averaged, or, with recompute_metrics, over the gathered
        transcripts; the metrics of the device's outputs (accuracy) are
        taken per batch on the device and averaged (model.py:425-439).
        Batch i + 1's forward is issued before batch i is decoded on the
        host. Under data parallelism every rank evaluates the whole of
        `dataset_eval`, each batch whole (no shard, no gather): the
        one-process losses and metrics on every rank."""
        if use_ema and self.ema_state is None:
            raise ValueError("use_ema=True without set_ema")
        was_training = self.model.training
        self.model.eval()
        loss_sums: Dict[str, torch.Tensor] = {}
        sums: Dict[str, float] = {}
        metric_of: Dict[str, Any] = {}
        truths: Dict[str, List[str]] = {}
        preds: Dict[str, List[str]] = {}
        n = 0

        device_sums: Dict[str, torch.Tensor] = {}

        def flush(pending):
            host_targets, decode_pre, metrics, decoders = pending
            names = _metric_names({k: metrics[k] for k in decode_pre})
            for key, pre in decode_pre.items():
                decoder = _as_list(decoders[key])[0]
                for i, metric in enumerate(metrics[key]):
                    mkey = names[key, i]
                    metric_of[mkey] = metric
                    t = decoder(host_targets[key], from_logits=False)
                    p = decoder(pre)
                    if verbose:
                        print("Groundtruths:\n", t)
                        print("Predictions:\n", p)
                    sums[mkey] = sums.get(mkey, 0.0) + float(metric(t, p))
                    if recompute_metrics or return_transcripts:
                        truths.setdefault(mkey, []).extend(t)
                        preds.setdefault(mkey, []).extend(p)

        pending = None
        batches = iter(dataset_eval)
        try:
            with torch.no_grad():
                for batch in batches:
                    inputs, targets = self._to_device(batch)
                    outputs = self._eval_forward(inputs, use_ema)
                    losses = self.compute_losses(outputs, targets, self.step)
                    for k, v in losses.items():
                        loss_sums[k] = loss_sums[k] + v if k in loss_sums \
                            else v
                    metrics = _by_output(self.metrics, outputs)
                    decoders = _by_output(self.decoders, outputs)
                    for k, v in self.device_metrics(outputs,
                                                    targets).items():
                        device_sums[k] = (device_sums[k] + v
                                          if k in device_sums else v)
                    on_host = {key: [m for m in _as_list(spec)
                                     if getattr(m, "on_host", False)]
                               for key, spec in metrics.items()}
                    decode_pre = {
                        key: _as_list(decoders[key])[0].device_fn(outputs[key])
                        for key, ms in on_host.items()
                        if ms and key in decoders}
                    n += 1
                    if pending is not None:
                        flush(pending)
                    pending = (_by_output(batch["targets"], outputs),
                               decode_pre, on_host, decoders)
                    if eval_steps and n >= eval_steps:
                        break
                if pending is not None:
                    flush(pending)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
            self.model.train(was_training)

        denom = max(n, 1)
        out_losses = {k: float(v) / denom for k, v in loss_sums.items()}
        out_metrics = {k: float(v) / denom for k, v in device_sums.items()}
        out_metrics.update({
            k: (float(metric_of[k](truths[k], preds[k])) if recompute_metrics
                else v / denom) for k, v in sums.items()})
        if return_transcripts:
            return out_losses, out_metrics, {k: (truths[k], preds[k])
                                             for k in truths}
        return out_losses, out_metrics

    def eval_time(self, dataset_eval, eval_steps: Optional[int] = None,
                  num_evals: int = 10, warmup_eval: bool = True
                  ) -> Dict[str, float]:
        """Seconds of `num_evals` evaluations (model.py:1053-1067): mean,
        std, min, max. Each ends on the host's read of its results."""
        if warmup_eval:
            self.evaluate(dataset_eval, eval_steps=eval_steps)
        times = []
        for _ in range(num_evals):
            start = time.perf_counter()
            self.evaluate(dataset_eval, eval_steps=eval_steps)
            times.append(time.perf_counter() - start)
        arr = np.asarray(times)
        return {"mean": float(arr.mean()), "std": float(arr.std()),
                "min": float(arr.min()), "max": float(arr.max())}

    def save_logits(self, dataset_eval, callback_path: str) -> None:
        """The eval-mode outputs and the targets of every batch of
        `dataset_eval`, pickled as lists of numpy trees to
        callback_path/logits.pkl and targets.pkl (model.py:1069-1085; bf16
        logits are written as fp32)."""
        import pickle

        logits_list, targets_list = [], []
        was_training = self.model.training
        self.model.eval()
        batches = iter(dataset_eval)
        try:
            with torch.no_grad():
                for batch in batches:
                    inputs, _ = self._to_device(batch)
                    logits_list.append(_to_numpy(self.model(*inputs)))
                    targets_list.append(_to_numpy(batch["targets"]))
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
            self.model.train(was_training)
        if self.rank == 0:
            os.makedirs(callback_path, exist_ok=True)
            with open(os.path.join(callback_path, "logits.pkl"), "wb") as f:
                pickle.dump(logits_list, f)
            with open(os.path.join(callback_path, "targets.pkl"), "wb") as f:
                pickle.dump(targets_list, f)

    def generate(self, dataset, saving_path: Optional[str] = None) -> None:
        """The generation loop (model.py:1039-1047): `forward_generate` of
        each batch's inputs, named "sample_{rank}_{i}"."""
        if saving_path is not None and self.rank == 0:
            os.makedirs(saving_path, exist_ok=True)
        for i, batch in enumerate(dataset):
            self.forward_generate(batch["inputs"], saving_path,
                                  f"sample_{self.rank}_{i}")

    def forward_generate(self, inputs, saving_path, name):
        """A generation model's forward (model.py:1049-1051): the model's
        own `forward_generate`; the task models have none."""
        fn = getattr(self.model, "forward_generate", None)
        if fn is None:
            raise NotImplementedError(
                "generation models must implement forward_generate")
        return fn(inputs, saving_path, name)

    # ------------------------------------------------------------ summary
    def num_params(self) -> int:
        """Parameters of the model (model.py:324-326; buffers not
        counted)."""
        return sum(p.numel() for p in self.model.parameters())

    def summary(self, show_dict: bool = False,
                show_modules: bool = False) -> None:
        """model.py:328-334: the model's name and parameter count; its
        state entries with show_dict, its module tree with show_modules."""
        name = getattr(self.model, "model_name", type(self.model).__name__)
        print(f"Model name: {name}")
        print("Number Parameters: {:,}".format(self.num_params()))
        if show_dict:
            self.show_dict()
        if show_modules:
            print(self.model)

    def show_dict(self) -> None:
        """model.py:336-345: each state entry's numel, shape, mean, std."""
        for i, (key, value) in enumerate(self.model.state_dict().items()):
            v = value.detach().float().cpu()
            print(f"{i:<4} {key:<80} numel: {v.numel():<10} shape: "
                  f"{str(tuple(v.shape)):<18} mean: {v.mean().item():<10.4f}"
                  f" std: {v.std(unbiased=False).item():<10.4f}")

    # --------------------------------------------------------- save/load
    def save(self, path: str, save_optimizer: bool = True) -> None:
        """A checkpoint in the reference's torch format (model.py:879-893).
        Under tensor parallelism every rank of the model group calls it: the
        shards are gathered and rank 0 writes the file a one-rank run
        writes (the same keys and shapes)."""
        state = self.model.state_dict()
        opt = (self.optimizer.optimizer.state_dict() if save_optimizer
               else None)
        ema = self.ema_state
        if self._sharded():
            group, dims = self.mesh.model, tp.sharded_names(self.model)
            state = tp.gather_state(state, dims, group)
            ema = None if ema is None else tp.gather_state(ema, dims, group)
            if opt is not None:
                params = [p for g in self.optimizer.optimizer.param_groups
                          for p in g["params"]]
                opt = tp.map_optimizer_state(
                    opt, params, lambda v, d: tp.gather_tensor(v, d, group),
                    whole=False)
            if self.rank != 0:
                return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_checkpoint(path, state, optimizer_state=opt,
                        model_step=self.step, ema_state=ema)
        self._log(f"Model saved at step {self.step}")

    def load(self, path: str, load_optimizer: bool = True,
             strict: bool = True,
             select: Optional[Callable[[str], bool]] = None,
             rename: Optional[Callable[[str], Optional[str]]] = None,
             verbose: bool = True) -> None:
        """Restore the model's parameters and buffers and, with
        load_optimizer, the optimizer state and the step (model.py:
        895-931); an EMA in the file is restored where `set_ema` is on.
        With `select`, a predicate on state_dict keys, only the model
        entries it keeps are loaded and nothing else, each key through
        `rename` when given: the partial load of the LRW front end into the
        VO model (model.py:282-294, configs/LRS23/VO/EffConfInterCTC.py:
        77-86, `select=lambda k: "front_end" in k`) and, renamed into its
        video encoder, the AV model (configs/LRS23/AV/EffConfInterCTC.py:
        80-91); a kept key the model lacks raises KeyError. The model's
        entries go through `train.checkpoint.restore_tree` with the JAX
        semantics (checkpoint.py:79-117): `rename` returning None drops a
        key; strict raises on a missing or unexpected key; non-strict keeps
        the model's values for what is missing. Under tensor parallelism
        every rank takes its shards of what it reads.

        A JAX msgpack checkpoint is read too (`train/checkpoint.py`): its
        parameters, batch statistics and EMA by `convert.params_from_jax`,
        and with load_optimizer its Adam moments and count into the torch
        optimizer's state under the same mapping, and the step. Moments
        that do not map one to one onto the model's parameters raise
        ValueError; none is skipped."""
        payload = load_checkpoint(path)
        template = self.model.state_dict()
        state = payload["model_state_dict"]
        if select is not None:
            state = {k: v for k, v in state.items() if select(k)}
        if rename is not None:
            state = {k2: v for k, v in state.items()
                     if (k2 := rename(k)) is not None}
        state = self._shard_read(state)
        if select is not None:
            unknown = sorted(set(state) - set(template))
            if unknown or not state:
                raise KeyError(f"partial load of {len(state)} entries; not "
                               f"in the model: {unknown[:5]}")
            self.model.load_state_dict(restore_tree(template, state,
                                                    strict=False))
            self._log(f"Applied partial checkpoint load ({len(state)} "
                      "entries)")
            return
        self.model.load_state_dict(restore_tree(template, state,
                                                strict=strict))
        if load_optimizer and payload.get("optimizer_state_dict") is not None:
            if payload["format"] == "jax":
                self._load_optax_adam(payload["optimizer_state_dict"])
            else:
                opt = payload["optimizer_state_dict"]
                if self._sharded():
                    opt = shard_like_params(opt, self.model, self.mesh,
                                            self.optimizer.optimizer)
                self.optimizer.optimizer.load_state_dict(opt)
            self.step = int(payload["model_step"])
        ema = self._shard_read(payload.get("ema_model_state_dict"))
        if ema is not None and self.ema_state is not None:
            missing = set(self.ema_state) - set(ema)
            if strict and (missing or set(ema) - set(self.ema_state)):
                raise KeyError(f"EMA state keys differ: missing "
                               f"{sorted(missing)[:5]}")
            with torch.no_grad():
                for k, v in ema.items():
                    if k in self.ema_state:
                        self.ema_state[k].copy_(v)
        if verbose:
            self._log(f"Rank {self.rank}: Model loaded at step {self.step}")

    def _shard_read(self, state):
        """A state read whole -> this rank's shards of the sharded
        parameters' entries (as it is without tensor parallelism)."""
        if state is None or not self._sharded():
            return state
        return shard_like_params(state, self.model, self.mesh)

    def _load_optax_adam(self, opt_state) -> None:
        """An optax Adam state (the JAX `Adam` / `AdamW` chains of
        avec_tpu/train/optim.py:72-95: one ScaleByAdamState {count, mu,
        nu} among empty or mask states) -> torch Adam's per-parameter
        {step, exp_avg, exp_avg_sq}. The optax moments are those of the
        same update rule (L2 added to the gradient before them for Adam,
        the decoupled decay after them for AdamW), so they carry over
        exactly."""
        from avec_tpu_torch.convert import params_from_jax

        found = []

        def walk(node):
            if isinstance(node, dict):
                if {"count", "mu", "nu"} <= set(node):
                    found.append(node)
                else:
                    for v in node.values():
                        walk(v)

        walk(opt_state)
        opt = self.optimizer.optimizer
        if len(found) != 1 or not isinstance(
                opt, (torch.optim.Adam, torch.optim.AdamW)):
            raise ValueError(
                f"the JAX optimizer state holds {len(found)} Adam moment "
                f"sets and the trainer's optimizer is "
                f"{type(opt).__name__}: they do not map one to one (load "
                f"with load_optimizer=False to take the weights alone)")
        adam = found[0]
        params = dict(self.model.named_parameters())
        moments = [self._shard_read(dict(params_from_jax(adam[k])))
                   for k in ("mu", "nu")]
        for got in moments:
            missing = sorted(set(params) - set(got))
            extra = sorted(set(got) - set(params))
            bad = [k for k in set(params) & set(got)
                   if tuple(got[k].shape) != tuple(params[k].shape)]
            if missing or extra or bad:
                raise ValueError(
                    f"the JAX Adam moments do not map one to one onto the "
                    f"model's parameters: missing {missing[:5]}, not in the "
                    f"model {extra[:5]}, shapes differ {bad[:5]}")
        count = float(np.asarray(adam["count"]))
        opt.state.clear()
        for name, p in params.items():
            opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": moments[0][name].to(p.device, torch.float32),
                "exp_avg_sq": moments[1][name].to(p.device, torch.float32)}

    # --------------------------------------------------------------- swa
    def swa(self, dataset, callback_path: str, start_epoch=None,
            end_epoch=None, epochs_list=None, update_steps=None,
            swa_type: str = "equal", swa_decay: float = 0.9,
            precision=None) -> str:
        """Stochastic weight averaging (model.py:965-1036): the parameters
        of each listed epoch's end-of-epoch checkpoint (its largest step)
        averaged equally ("equal") or exponentially ("exp", each new one
        weighted swa_decay); then the BatchNorm statistics re-estimated by
        training-mode forwards over `update_steps` batches (default: one
        pass over `dataset`) from the last loaded checkpoint's statistics.
        Saves and returns "checkpoints_swa-{type}-{first}-{last}.ckpt"."""
        if swa_type not in ("equal", "exp"):
            raise ValueError(f"swa_type {swa_type!r}")
        if precision is not None:
            self.dtype = resolve_precision(precision)
        if epochs_list is None:
            epochs_list = list(range(int(start_epoch), int(end_epoch) + 1))
        self._log(f"Stochastic Weight Averaging on checkpoints : "
                  f"{epochs_list}")
        avg: Optional[List[torch.Tensor]] = None
        for n_avg, epoch in enumerate(epochs_list):
            matches = glob.glob(os.path.join(
                callback_path, f"checkpoints_epoch_{epoch}_step_*.ckpt"))
            if not matches:
                raise FileNotFoundError(f"no checkpoint for epoch {epoch} in "
                                        f"{callback_path}")
            matches.sort(key=lambda p: int(
                re.search(r"_step_(\d+)\.ckpt$", p).group(1)))
            self.load(matches[-1], load_optimizer=False, strict=True,
                      verbose=False)
            params = [p.detach().clone() for p in self.model.parameters()]
            if avg is None:
                avg = params
            elif swa_type == "equal":
                avg = [a + (b - a) / (n_avg + 1) for a, b in zip(avg, params)]
            else:
                avg = [(1 - swa_decay) * a + swa_decay * b
                       for a, b in zip(avg, params)]
        with torch.no_grad():
            for p, a in zip(self.model.parameters(), avg):
                p.copy_(a)

        self._log("Updating Batch Normalization Statistics")
        self.model.train()
        update_steps = (update_steps if update_steps is not None
                        else len(dataset))
        steps = 0
        while steps < update_steps:
            batches = iter(dataset)
            try:
                with torch.no_grad():     # the statistics need no gradient
                    for batch in batches:
                        inputs, _ = self._to_device(batch)
                        self.model(*inputs)
                        steps += 1
                        if steps >= update_steps:
                            break
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
        path = os.path.join(callback_path, f"checkpoints_swa-{swa_type}-"
                                           f"{epochs_list[0]}-"
                                           f"{epochs_list[-1]}.ckpt")
        if self._saves():
            self.save(path, save_optimizer=False)
        if self.group is not None:
            sync_global_devices("swa", self.group)
        return path
