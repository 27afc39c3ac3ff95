"""JAX-package variables -> the port's state_dict (inverse of
avec_tpu/train/torch_convert.py:59-266).

The port names its parameters as the reference `nnet` state_dict does, so the
rules of the JAX package's torch converter apply here in the other direction:

  kernel (I, O)             -> Linear weight (O, I)
  conv kernel (*k, I/g, O)  -> Conv weight (O, I/g, *k)
  audio stem `linear` kernel (F*C, O), frequency-major
                            -> weight (O, C*F), channel-major
  scale / bias              -> weight / bias
  pos_kernel / pos_bias     -> pos_layer.weight (transposed) / pos_layer.bias
  u / v (Transformer-XL)    -> u / v
  embedding / pos_encoding  -> Embedding weight / pos_encoding (GPT)
  batch_stats mean / var    -> running_mean / running_var
  blocks_{F}_{L}.block.*    -> conformer_blocks.{F..L}.* (unstacked scan run)
  interctc_{N}              -> interctc_modules.{ordinal of N in its scope}
  transformer.block_{N}     -> transformer.blocks.{N} (GPT), its ff_module
                               layers {0, 1, 4}, PosEmbedding1d_0 ->
                               pos_embedding, LayerNorm_0 -> layernorm

Inputs are nested dicts of numpy arrays (the flax `params` and
`batch_stats` trees); the output maps state_dict keys to fp32 CPU tensors.

`state_to_jax` and `grads_to_jax_layout` are the inverse map: the port's
tensors by state_dict key (parameters, their gradients, or updated running
statistics) back into trees of the JAX layout, transposes and scan stacking
included, so that they compare leaf by leaf with the JAX trees.
"""

import re
from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_SCAN_RE = re.compile(r"^blocks_(\d+)_(\d+)$")
_BLOCK_RE = re.compile(r"^block_(\d+)$")
_INTERCTC_RE = re.compile(r"^interctc_(\d+)$")
_ATT_RE = re.compile(r".*Attention_\d+$")

_CONV_MODULE_IDX = {"LayerNorm_0": "layers.0", "Conv_0": "layers.1",
                    "Conv_1": "layers.3", "BatchNorm_0": "layers.4",
                    "Conv_2": "layers.6"}
_FF_MODULE_IDX = {"LayerNorm_0": "layers.0", "Linear_0": "layers.1",
                  "Linear_1": "layers.4"}
_RESNET_IDX = {"conv1": "layers.0", "bn1": "layers.1", "conv2": "layers.3",
               "bn2": "layers.4", "res_conv": "residual.0",
               "res_bn": "residual.1"}


def _linear(k):
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k):
    k = np.asarray(k)
    nd = k.ndim - 2
    return np.ascontiguousarray(k.transpose((nd + 1, nd) + tuple(range(nd))))


def _identity(k):
    return np.asarray(k)


def _audio_stem_linear(k):
    """(F*C, O) frequency-major -> (O, C*F) channel-major; C == O (180)."""
    k = np.asarray(k)
    in_dim, out_dim = k.shape
    c, f = out_dim, in_dim // out_dim
    return np.ascontiguousarray(k.reshape(f, c, out_dim).transpose(2, 1, 0)
                                .reshape(out_dim, c * f))


def _conv_inv(w):
    """(O, I/g, *k) -> (*k, I/g, O)."""
    w = np.asarray(w)
    nd = w.ndim - 2
    return np.ascontiguousarray(w.transpose(tuple(range(2, nd + 2)) + (1, 0)))


def _audio_stem_linear_inv(w):
    """(O, C*F) channel-major -> (F*C, O) frequency-major; C == O."""
    w = np.asarray(w)
    out_dim, in_dim = w.shape
    c, f = out_dim, in_dim // out_dim
    return np.ascontiguousarray(w.reshape(out_dim, c, f).transpose(2, 1, 0)
                                .reshape(f * c, out_dim))


_INVERSE = {_linear: _linear, _conv: _conv_inv, _identity: _identity,
            _audio_stem_linear: _audio_stem_linear_inv}


def _leaf_rule(segs: List[str], leaf: str, in_batch_stats: bool):
    parent = segs[-1] if segs else ""
    if in_batch_stats:
        return {"mean": "running_mean", "var": "running_var"}[leaf], _identity
    if leaf in ("scale", "bias"):
        return ("weight" if leaf == "scale" else "bias"), _identity
    if leaf == "kernel":
        if parent == "linear":
            return "weight", _audio_stem_linear
        if "conv" in parent.lower():
            return "weight", _conv
        return "weight", _linear
    if leaf == "pos_kernel":
        return "pos_layer.weight", _linear
    if leaf == "pos_bias":
        return "pos_layer.bias", _identity
    if leaf in ("u", "v"):      # RelPosMultiHeadSelfAttention's biases
        return leaf, _identity
    if leaf == "embedding":
        return "weight", _identity
    if leaf == "pos_encoding":
        return "pos_encoding", _identity
    raise KeyError(f"no rule for leaf {leaf!r} under {'.'.join(segs)}")


def _map_segments(segs: List[str], ordinals: Dict[str, Dict[int, int]]) -> str:
    out: List[str] = []
    i = 0
    while i < len(segs):
        s, prev = segs[i], (segs[i - 1] if i else "")
        m = _BLOCK_RE.match(s)
        if m:
            out.append(f"blocks.{m.group(1)}"
                       if prev in ("front_end_resnet", "transformer")
                       else f"conformer_blocks.{m.group(1)}")
            i += 1
        elif _INTERCTC_RE.match(s):
            n = int(_INTERCTC_RE.match(s).group(1))
            out.append(f"interctc_modules.{ordinals['.'.join(segs[:i])][n]}")
            i += 1
        elif s == "front_end_stem":
            out.append({"conv_0": "front_end.0.layers.0.0",
                        "BatchNorm_0": "front_end.0.layers.0.1"}[segs[i + 1]])
            i += 2
        elif s == "front_end_resnet":
            if segs[i + 1] == "head":
                out.append("front_end.3.head.1")
                i += 2
            else:
                out.append("front_end.3")
                i += 1
        elif s == "subsampling_module":
            out.append({"conv_0": "subsampling_module.layers.0.0",
                        "BatchNorm_0": "subsampling_module.layers.0.1"}[
                            segs[i + 1]])
            i += 2
        elif s == "fusion_module":
            out.append({"Linear_0": "fusion_module.layers.0",
                        "Linear_1": "fusion_module.layers.2"}[segs[i + 1]])
            i += 2
        elif (_BLOCK_RE.match(prev) and s in _RESNET_IDX
              and "front_end.3" in ".".join(out)):
            out.append(_RESNET_IDX[s])
            i += 1
        elif s.startswith(("PosEmbedding", "SinPosEmbedding")):
            out.append("pos_embedding")
            i += 1
        elif s in ("ff_module1", "ff_module2", "ff_module"):
            out.append(s + "." + _FF_MODULE_IDX[segs[i + 1]])
            i += 2
        elif s == "conv_module":
            out.append(s + "." + _CONV_MODULE_IDX[segs[i + 1]])
            i += 2
        elif s == "self_att_module":
            nxt = segs[i + 1]
            if nxt == "LayerNorm_0":
                out.append("self_att_module.norm")
            elif _ATT_RE.match(nxt):
                out.append("self_att_module.attention")
            else:
                raise KeyError(f"self_att_module child {nxt!r}")
            i += 2
        elif s == "LayerNorm_0":
            out.append("layernorm" if prev == "transformer" else "norm")
            i += 1
        else:
            out.append(s)
            i += 1
    return ".".join(out)


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


def _interctc_ordinals(paths) -> Dict[str, Dict[int, int]]:
    scopes: Dict[str, set] = {}
    for segs in paths:
        for i, s in enumerate(segs):
            m = _INTERCTC_RE.match(s)
            if m:
                scopes.setdefault(".".join(segs[:i]), set()).add(int(m.group(1)))
    return {scope: {n: j for j, n in enumerate(sorted(ns))}
            for scope, ns in scopes.items()}


def _torch_entries(segs: List[str], leaf: str, in_bs: bool, ordinals
                   ) -> List[Tuple[str, Callable]]:
    """One (key, transform) per scan slice, or one for a plain leaf."""
    for i, s in enumerate(segs):
        m = _SCAN_RE.match(s)
        if m:
            assert segs[i + 1] == "block", segs
            entries = []
            for n in range(int(m.group(1)), int(m.group(2)) + 1):
                sub = segs[:i] + [f"block_{n}"] + segs[i + 2:]
                tleaf, tf = _leaf_rule(sub, leaf, in_bs)
                entries.append((f"{_map_segments(sub, ordinals)}.{tleaf}", tf))
            return entries
    tleaf, tf = _leaf_rule(segs, leaf, in_bs)
    prefix = _map_segments(segs, ordinals)
    return [(f"{prefix}.{tleaf}" if prefix else tleaf, tf)]


def params_from_jax(params, batch_stats=None) -> "OrderedDict[str, torch.Tensor]":
    """JAX `params` / `batch_stats` trees -> the port's state_dict."""
    leaves = [(segs, arr, False) for segs, arr in _flatten(params).items()]
    leaves += [(segs, arr, True)
               for segs, arr in _flatten(batch_stats or {}).items()]
    ordinals = _interctc_ordinals([segs for segs, _, _ in leaves])
    sd = OrderedDict()
    for segs, arr, in_bs in leaves:
        segs, leaf = list(segs[:-1]), segs[-1]
        entries = _torch_entries(segs, leaf, in_bs, ordinals)
        slices = [arr] if len(entries) == 1 else list(arr)
        for (key, tf), a in zip(entries, slices):
            sd[key] = torch.from_numpy(
                np.ascontiguousarray(tf(a), dtype=np.float32))
    return sd


def _flatten_paths(tree, prefix=()) -> List[Tuple[str, ...]]:
    paths = []
    for k, v in tree.items():
        if hasattr(v, "items"):
            paths += _flatten_paths(v, prefix + (str(k),))
        else:
            paths.append(prefix + (str(k),))
    return paths


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v)


def _tree_to_jax(values, template, in_bs: bool, ordinals):
    out = {}
    for path in _flatten_paths(template):
        segs, leaf = list(path[:-1]), path[-1]
        entries = _torch_entries(segs, leaf, in_bs, ordinals)
        arrs = [_INVERSE[tf](_to_numpy(values[key])) for key, tf in entries]
        arr = arrs[0] if len(arrs) == 1 else np.stack(arrs)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def state_to_jax(values, params_template, batch_stats_template=None):
    """The port's tensors by state_dict key -> (params, batch_stats) trees
    in the JAX layout. The templates are the JAX trees (any leaves): only
    their structure is read."""
    paths = _flatten_paths(params_template)
    paths += _flatten_paths(batch_stats_template or {})
    ordinals = _interctc_ordinals([p[:-1] for p in paths])
    params = _tree_to_jax(values, params_template, False, ordinals)
    stats = _tree_to_jax(values, batch_stats_template or {}, True, ordinals)
    return params, stats


def grads_to_jax_layout(grads, params_template):
    """Gradients by parameter name -> a tree shaped like the JAX `params`."""
    return state_to_jax(grads, params_template)[0]
