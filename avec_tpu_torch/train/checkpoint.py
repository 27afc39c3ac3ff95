"""Checkpoints in the reference's torch format (port of
avec_tpu/train/checkpoint.py:52-146).

A checkpoint is one `torch.save` file of a dict:

  model_state_dict      the model's state_dict (the reference `nnet` names)
  optimizer_state_dict  the torch optimizer's state_dict, or None
  model_step            int
  is_distributed        False (kept for the format)
  ema_model_state_dict  the EMA model's state_dict, or None

It is written to `path + ".tmp"`, then moved over `path`, so a reader never
sees half a file. The JAX package reads such a file through its `Model.load`
(a torch checkpoint is converted by name, avec_tpu/train/model.py:933-963).

Names: "checkpoints_epoch_{E}_step_{S}.ckpt" and, for SWA,
"checkpoints_swa-{type}-{first}-{last}.ckpt"; `find_last_checkpoint`
picks the file of the largest step.
"""

import glob
import os
from typing import Any, Dict, Optional

import torch


def _to_cpu(state: Optional[Dict[str, torch.Tensor]]):
    if state is None:
        return None
    return {k: v.detach().cpu() for k, v in state.items()}


def save_checkpoint(path: str, model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    model_step: int = 0,
                    ema_state: Optional[Dict[str, torch.Tensor]] = None):
    payload = {
        "model_state_dict": _to_cpu(model_state),
        "optimizer_state_dict": optimizer_state,
        "model_step": int(model_step),
        "is_distributed": False,
        "ema_model_state_dict": _to_cpu(ema_state),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _strip_module(state):
    """Keys of a DistributedDataParallel state_dict lose their "module."
    prefix (the reference's model.py:521-522)."""
    if state is None:
        return None
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, tensors on the CPU. A file that holds a bare
    state_dict is read as a checkpoint of step 0."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "model_state_dict" not in payload:
        payload = {"model_state_dict": payload, "model_step": 0,
                   "optimizer_state_dict": None, "ema_model_state_dict": None}
    payload["model_state_dict"] = _strip_module(payload["model_state_dict"])
    payload["ema_model_state_dict"] = _strip_module(
        payload.get("ema_model_state_dict"))
    return payload


def find_last_checkpoint(callback_path: str,
                         return_full_path: bool = False) -> Optional[str]:
    """The "checkpoints_*.ckpt" file of the largest step (the reference's
    functions.py:25-44); None if there is none."""
    checkpoints = glob.glob(os.path.join(callback_path, "checkpoints_*.ckpt"))
    max_steps, last = 0, None
    for ckpt in checkpoints:
        name = os.path.basename(ckpt)
        try:
            steps = int(name.split("_")[-1].replace(".ckpt", ""))
        except ValueError:
            continue
        if steps > max_steps:
            max_steps, last = steps, name
    if last is not None and return_full_path:
        return os.path.join(callback_path, last)
    return last
