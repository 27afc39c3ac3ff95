"""Per-module auxiliary losses and infos (port of
avec_tpu/ops/module_utils.py).

A module calls `add_loss(self, name, loss, weight)` or
`add_info(self, name, value)` in its forward; the records live on the
module. The training engine clears every record of the model before each
forward and harvests them after it (`train/model.py`): it adds
weight * loss to the total loss and reports it as `loss_<name>`, and it
returns the infos of each step. A later record of the same name replaces an
earlier one, as a flax `sow` with a replacing `reduce_fn` does.
"""

from typing import Any, Dict, Tuple

import torch.nn as nn

_LOSSES = "_aux_losses"
_INFOS = "_aux_infos"


def add_loss(module: nn.Module, name: str, loss, weight: float = 1.0) -> None:
    """Record an auxiliary loss of `module` (module_utils.py:30-33)."""
    module.__dict__.setdefault(_LOSSES, {})[name] = (loss, weight)


def add_info(module: nn.Module, name: str, value) -> None:
    """Record an info of `module` (module_utils.py:36-38)."""
    module.__dict__.setdefault(_INFOS, {})[name] = value


def clear_records(model: nn.Module) -> None:
    """Drop every loss and info recorded in `model`'s modules."""
    for m in model.modules():
        m.__dict__.pop(_LOSSES, None)
        m.__dict__.pop(_INFOS, None)


def _harvest(model: nn.Module, key: str) -> Dict[str, Any]:
    out = {}
    for m in model.modules():
        out.update(m.__dict__.get(key, {}))
    return out


def harvest_aux_losses(model: nn.Module) -> Dict[str, Tuple[Any, float]]:
    """{name: (loss, weight)} of every module of `model`
    (module_utils.py:41-52)."""
    return _harvest(model, _LOSSES)


def harvest_infos(model: nn.Module) -> Dict[str, Any]:
    """{name: value} of every module of `model`."""
    return _harvest(model, _INFOS)
