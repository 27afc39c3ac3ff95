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

`load_checkpoint` also reads the JAX package's checkpoints: flax's
`msgpack_serialize` of the same five entries (avec_tpu/train/checkpoint.py:
52-76), the model and EMA states flat {"params.<path>" / "batch_stats.
<path>": array} and the optimizer state the optax tree as a state dict. The
two formats are told apart by the file's first bytes (a torch zip starts
with "PK", a legacy torch pickle with 0x80 and its protocol, a msgpack map
with 0x81-0x8f, 0xde or 0xdf). The msgpack file is decoded without flax:
its ndarray extension (code 1: shape, dtype name, C-order bytes), numpy
scalars (code 3) and arrays chunked over 2^30 bytes. `msgpack` is imported
only when such a file is read. The model and EMA states come back as the
port's state_dicts (`convert.params_from_jax`); the optimizer state stays
the optax tree, for `Trainer.load` to map (`format` is "jax").

Names: "checkpoints_epoch_{E}_step_{S}.ckpt" and, for SWA,
"checkpoints_swa-{type}-{first}-{last}.ckpt"; `find_last_checkpoint`
picks the file of the largest step.
"""

import glob
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


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


def checkpoint_format(path: str) -> str:
    """"torch" or "jax" (msgpack), from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"PK" or (len(head) == 2 and head[0] == 0x80
                             and 2 <= head[1] <= 5):
        return "torch"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "jax"
    raise ValueError(f"{path}: neither a torch checkpoint nor a JAX msgpack "
                     f"checkpoint (first bytes {head!r})")


def _msgpack():
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading a JAX checkpoint (msgpack) needs the "
                          "msgpack package, which is not installed") from e
    return msgpack


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = torch.from_numpy(np.frombuffer(buf, np.int16).copy())
        return bits.view(torch.bfloat16).float().numpy().reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(path: str) -> Any:
    """The tree of a flax `msgpack_serialize` file (flax's
    `msgpack_restore`), arrays as numpy (bfloat16 widened to float32)."""
    msgpack = _msgpack()

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        if code == _EXT_COMPLEX:
            re_im = msgpack.unpackb(data)
            return complex(re_im[0], re_im[1])
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def unflatten(flat: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}} (flax's unflatten_dict)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def state_from_jax(flat: Optional[Dict[str, Any]]):
    """A JAX checkpoint's flat model (or EMA) state -> the port's
    state_dict."""
    if flat is None:
        return None
    from avec_tpu_torch.convert import params_from_jax

    tree = unflatten(flat)
    return dict(params_from_jax(tree.get("params", {}),
                                tree.get("batch_stats") or None))


def _load_jax(path: str) -> Dict[str, Any]:
    raw = read_msgpack(path)
    return {"model_state_dict": state_from_jax(raw["model_state_dict"]),
            "optimizer_state_dict": raw.get("optimizer_state_dict"),
            "model_step": int(raw.get("model_step", 0)),
            "is_distributed": bool(raw.get("is_distributed", False)),
            "ema_model_state_dict": state_from_jax(
                raw.get("ema_model_state_dict")),
            "format": "jax"}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, tensors on the CPU, from a torch file or a JAX
    msgpack file (its states converted to the port's names; "format" says
    which). A torch file that holds a bare state_dict is read as a
    checkpoint of step 0."""
    if checkpoint_format(path) == "jax":
        return _load_jax(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "model_state_dict" not in payload:
        payload = {"model_state_dict": payload, "model_step": 0,
                   "optimizer_state_dict": None, "ema_model_state_dict": None}
    payload["model_state_dict"] = _strip_module(payload["model_state_dict"])
    payload["ema_model_state_dict"] = _strip_module(
        payload.get("ema_model_state_dict"))
    payload["format"] = "torch"
    return payload


def find_last_checkpoint(callback_path: str,
                         return_full_path: bool = False) -> Optional[str]:
    """The "checkpoints_*.ckpt" file of the largest step (the reference's
    functions.py:25-44), in either format (both packages write
    "checkpoints_epoch_{e}_step_{s}.ckpt"); None if there is none."""
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
