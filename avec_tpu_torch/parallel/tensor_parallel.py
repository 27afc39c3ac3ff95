"""Tensor parallelism over the 'model' axis of the mesh (port of
avec_tpu/parallel/mesh.py:137-224 and of the collectives GSPMD inserts for
those shardings).

The JAX package states which parameters are sharded over the mesh's 'model'
axis and lets GSPMD place the collectives. Here a sharded parameter holds
only this rank's slice and the forwards say where the activations meet:

  * `copy_in`: identity forward, sum of the cotangent over the model group
    backward (a replicated activation entering a sharded layer);
  * `reduce_out`: sum over the model group forward, identity backward (the
    partial products of a row-parallel layer);
  * `gather`: the ranks' slices concatenated along a dimension forward, this
    rank's slice of the cotangent backward;
  * `scatter`: this rank's slice forward, the slices gathered backward (a
    replicated activation entering a row-parallel layer).

A gather is one all-reduce of a zero-filled tensor into which each rank
writes its slice: gloo, which runs ranks that share one card, has an
all-reduce for CUDA tensors and no all-gather, so every backend takes that
one route. Adding zeros is exact, so the result is the concatenation.

`param_shardings` maps (regex, dim) rules over the parameter names (the
reference's, e.g. "transformer.blocks.0.ff_module.layers.1.weight") to the
dimension each parameter is sharded on, or None; `shard_module` replaces
each sharded parameter's data by this rank's slice, marks the parameter
(`tp_dim`, `tp_shape`) and puts the layers that hold them behind
`ParallelLinear` / `ParallelEmbedding`, which place those collectives, so
the models keep one forward; `gather_state` and `shard_state` move a state dict
(and an optimizer's per-parameter state) between the whole and the shards.
"""

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' equal slices of a tensor, concatenated along `dim` in rank
    order (no gradient)."""
    n = _size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    full = x.new_zeros(shape)
    full.narrow(dim, dist.get_rank(group) * x.shape[dim],
                x.shape[dim]).copy_(x)
    dist.all_reduce(full, group=group)
    return full


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_tensor(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_tensor(g, ctx.dim, ctx.group), None, None


def copy_in(x, group):
    return _CopyIn.apply(x, group) if _size(group) > 1 else x


def reduce_out(x, group):
    return _ReduceOut.apply(x, group) if _size(group) > 1 else x


def gather(x, group, dim: int = -1):
    return _Gather.apply(x, dim, group) if _size(group) > 1 else x


def scatter(x, group, dim: int = -1):
    return _Scatter.apply(x, dim, group) if _size(group) > 1 else x


# ---- layers over sharded parameters

def tp_dim(p: Optional[torch.Tensor]) -> Optional[int]:
    """The dimension `shard_module` sharded `p` on, None if replicated."""
    return getattr(p, "tp_dim", None)


class ParallelLinear(nn.Module):
    """A `Linear` layer whose weight `shard_module` sharded, holding the
    same Parameter objects under the same names. Column-parallel (weight
    sharded on dim 0, bias likewise): the input enters through `copy_in`;
    the output is this rank's columns (`split_out`) or gathered.
    Row-parallel (dim 1): the input is this rank's columns (`split_in`) or
    replicated and cut by `scatter`; the partial products are summed by
    `reduce_out` and the replicated bias is added once, after the sum."""

    def __init__(self, lin: nn.Module, group, split_in: bool = False,
                 split_out: bool = False):
        super().__init__()
        self.weight, self.bias = lin.weight, lin.bias
        self.group, self.split_in, self.split_out = group, split_in, split_out

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if tp_dim(self.weight) == 1:
            if not self.split_in:
                x = scatter(x, self.group)
            y = reduce_out(F.linear(x, w), self.group)
            return y if b is None else y + b
        y = F.linear(copy_in(x, self.group), w, b)
        return y if self.split_out else gather(y, self.group)


class ParallelEmbedding(nn.Module):
    """An `Embedding` whose table is sharded on the hidden dimension (dim
    1): each rank looks up its columns, then `gather` joins them."""

    def __init__(self, emb: nn.Module, group):
        super().__init__()
        self.weight, self.padding_idx = emb.weight, emb.padding_idx
        self.group = group

    def forward(self, ids):
        return gather(F.embedding(ids, self.weight), self.group)


# ---- shardings

def gpt_tensor_parallel_rules() -> List[Tuple[str, int]]:
    """Megatron-style rules for the GPT stack (mesh.py:211-224) over the
    port's parameter names, (regex, dim) with torch's (out, in) weights:
    column-parallel FFN-in (`layers.1`) and query / key / value layers with
    their biases, row-parallel FFN-out (`layers.4`) and attention output
    (biases replicated), the embedding table on its hidden dimension, the
    head's weight and bias on the vocabulary."""
    return [
        (r"ff_module\.layers\.1\.weight$", 0),
        (r"ff_module\.layers\.1\.bias$", 0),
        (r"ff_module\.layers\.4\.weight$", 1),
        (r"(query|key|value)_layer\.weight$", 0),
        (r"(query|key|value)_layer\.bias$", 0),
        (r"output_layer\.weight$", 1),
        (r"(^|\.)embedding\.weight$", 1),
        (r"(^|\.)head\.weight$", 0),
        (r"(^|\.)head\.bias$", 0),
    ]


def param_shardings(mesh, module: nn.Module,
                     rules: Sequence[Tuple[str, int]]
                     ) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension it is sharded on, or None} over the
    model axis of `mesh` (a `dist.Mesh`, or the axis size): the first rule
    whose regex matches the name (re.search) decides; it applies only where
    the model axis's size divides that dimension, else the parameter is
    replicated (mesh.py:137-170)."""
    model_size = mesh if isinstance(mesh, int) else mesh.model_size
    out = {}
    for name, p in module.named_parameters():
        dim = None
        for pat, d in rules:
            if re.search(pat, name):
                if d < p.dim() and p.shape[d] % model_size == 0:
                    dim = d
                break
        out[name] = dim
    return out


def shard_module(module: nn.Module, mesh, rules) -> Dict[str, Optional[int]]:
    """Shard `module`'s parameters over `mesh`'s model group by `rules`:
    each sharded parameter keeps only this rank's slice (the same Parameter
    object, so optimizers and masks by identity see it) and is marked with
    `tp_dim` and its whole shape `tp_shape`. Each `Linear` or `Embedding`
    with a sharded weight becomes a `ParallelLinear` / `ParallelEmbedding`
    under the same name, so the modules above it keep their forwards.

    A column-parallel output stays split only into the row-parallel layer
    it feeds: FFN-in into FFN-out, and the query / key / value into the
    attention output where the model group's size divides the head count
    (the attention then runs on its local heads). Elsewhere a column-
    parallel output is gathered and a row-parallel input cut by `scatter`:
    where mp does not divide the head count, q, k, v are gathered and every
    rank attends over all heads, as GSPMD reshards. Returns the
    shardings."""
    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops.attention import MultiHeadAttention
    from avec_tpu_torch.ops.layers import Embedding, Linear

    shardings = param_shardings(mesh, module, rules)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, dim in shardings.items():
            if dim is None:
                continue
            p = params[name]
            shape = tuple(p.shape)
            p.data = _own_slice(p.data, dim, mesh.model).clone()
            p.tp_dim, p.tp_shape = dim, shape
    split = set()
    for m in module.modules():
        if ((getattr(m, "fused_ffn", False) or getattr(m, "fused_att", False))
                and any(tp_dim(p) is not None for p in m.parameters())):
            raise ValueError(f"{type(m).__name__}'s fused kernels take whole "
                             "weights: turn fused_ffn / fused_att off to "
                             "shard its layers")
        if isinstance(m, FeedForwardModule):
            pair = [m.layers["1"], m.layers["4"]]
        elif (type(m) is MultiHeadAttention
              and m.num_heads % mesh.model_size == 0):
            pair = [m.query_layer, m.key_layer, m.value_layer, m.output_layer]
        else:
            continue
        if (all(tp_dim(lin.weight) == 0 for lin in pair[:-1])
                and tp_dim(pair[-1].weight) == 1):
            split.update(map(id, pair))
            if isinstance(m, MultiHeadAttention):
                m.num_heads //= mesh.model_size
                m.dim_model //= mesh.model_size
    for m in list(module.modules()):
        for name, child in list(m.named_children()):
            dim = tp_dim(getattr(child, "weight", None))
            if isinstance(child, Linear):
                bias = None if child.bias is None else tp_dim(child.bias)
                if bias != (0 if dim == 0 and child.bias is not None
                            else None):
                    raise ValueError(f"{name}: a bias shards with its "
                                     "column-parallel weight only")
                if dim is not None:
                    setattr(m, name, ParallelLinear(
                        child, mesh.model, split_in=id(child) in split,
                        split_out=id(child) in split))
            elif dim == 1 and isinstance(child, Embedding):
                setattr(m, name, ParallelEmbedding(child, mesh.model))
            elif any(tp_dim(p) is not None
                     for p in child.parameters(recurse=False)):
                raise ValueError(f"{name}: no tensor-parallel form of a "
                                 f"{type(child).__name__} sharded so")
    return shardings


def sharded_names(module: nn.Module) -> Dict[str, int]:
    """{name: dim} of `module`'s sharded parameters."""
    return {n: p.tp_dim for n, p in module.named_parameters()
            if tp_dim(p) is not None}


def gather_state(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                 group) -> Dict[str, torch.Tensor]:
    """A state dict whose entries named in `dims` are this rank's slices ->
    the whole state dict (every rank of the model group must call it)."""
    return {k: (gather_tensor(v.detach(), dims[k], group) if k in dims
                else v) for k, v in state.items()}


def shard_state(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                group) -> Dict[str, torch.Tensor]:
    """A whole state dict -> this rank's slices of the entries named in
    `dims` (the others as they are)."""
    return {k: (_own_slice(v, dims[k], group) if k in dims else v)
            for k, v in state.items()}


def map_optimizer_state(opt_state: dict, params: List[torch.Tensor], fn,
                        whole: bool) -> dict:
    """A torch optimizer state_dict with `fn(tensor, dim)` applied to every
    per-parameter tensor of a sharded parameter that has the parameter's
    whole shape (`whole`) or its shard's: Adam's moments, not its step
    counter (mesh.py:177-208: state placed like its parameter)."""
    state = {}
    for idx, entry in opt_state["state"].items():
        p = params[idx]
        dim = tp_dim(p)
        shape = p.tp_shape if whole and dim is not None else tuple(p.shape)
        state[idx] = {k: (fn(v, dim) if dim is not None and isinstance(
            v, torch.Tensor) and tuple(v.shape) == shape else v)
            for k, v in entry.items()}
    return {**opt_state, "state": state}
