"""JAX-package variables -> the port's state_dict (inverse of
avec_tpu/train/torch_convert.py:59-266).

The port names its parameters as the reference `nnet` state_dict does, so the
rules of the JAX package's torch converter apply here in the other direction:

  kernel (I, O)             -> Linear weight (O, I)
  conv kernel (*k, I/g, O)  -> Conv weight (O, I/g, *k) (a kernel's rank
                               tells the two apart)
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
  a ResNet at the root      -> stem.{0, 1}, blocks.{N}.layers.{0, 1, 3, 4,
                               6, 7} (conv1, bn1, conv2, bn2, conv3, bn3),
                               residual.{0, 1}, head.1
  convt_{N} / ConvTranspose_{N} kernel (*k, I, O)
                            -> ConvTranspose weight (I, O, *k)
  GroupNorm_{N}.GroupNorm_0 -> GroupNorm_{N} (the flax GroupNorm inside
                               the JAX wrapper; at the root, the wrapper
                               itself)
  OptimizedLSTMCell_{K}     -> an LSTM's weight_ih_l{L}, weight_hh_l{L},
                               bias_ih_l{L} (zeros) and bias_hh_l{L}, with
                               `_reverse` for the second direction: the
                               gate kernels ii, if, ig, io and hi, hf, hg,
                               ho (with their biases) stacked in the order
                               i, f, g, o; cell K is layer K // D,
                               direction K % D, D = 2 when bidirectional

The library modules that no AVEC model uses (the MLP, Inception and
ConvTranspose stacks) name their children as the JAX modules do, so their
paths pass through unchanged.

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
_CONVT_RE = re.compile(r"^(convt|ConvTranspose)_\d+$")
_GROUPNORM_RE = re.compile(r"^GroupNorm_\d+$")
_LSTM_RE = re.compile(r"^OptimizedLSTMCell_(\d+)$")
_BLOCK_RE = re.compile(r"^block_(\d+)$")
_INTERCTC_RE = re.compile(r"^interctc_(\d+)$")
_ATT_RE = re.compile(r".*Attention_\d+$")

_CONV_MODULE_IDX = {"LayerNorm_0": "layers.0", "Conv_0": "layers.1",
                    "Conv_1": "layers.3", "BatchNorm_0": "layers.4",
                    "Conv_2": "layers.6"}
_FF_MODULE_IDX = {"LayerNorm_0": "layers.0", "Linear_0": "layers.1",
                  "Linear_1": "layers.4"}
_RESNET_IDX = {"conv1": "layers.0", "bn1": "layers.1", "conv2": "layers.3",
               "bn2": "layers.4", "conv3": "layers.6", "bn3": "layers.7",
               "res_conv": "residual.0", "res_bn": "residual.1"}
_RESNET_STEM = {"stem_conv": "stem.0", "stem_bn": "stem.1"}
_RESNET_ROOT = "front_end.3."
_LSTM_GATES = ("i", "f", "g", "o")


def _linear(k):
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k):
    k = np.asarray(k)
    nd = k.ndim - 2
    return np.ascontiguousarray(k.transpose((nd + 1, nd) + tuple(range(nd))))


def _identity(k):
    return np.asarray(k)


def _convt(k):
    """ConvTranspose kernel (*k, I, O) -> weight (I, O, *k)."""
    k = np.asarray(k)
    nd = k.ndim - 2
    return np.ascontiguousarray(k.transpose((nd, nd + 1) + tuple(range(nd))))


def _convt_inv(w):
    w = np.asarray(w)
    nd = w.ndim - 2
    return np.ascontiguousarray(w.transpose(tuple(range(2, nd + 2)) + (0, 1)))


def _kernel(k):
    """A kernel by its rank: Linear (I, O) or Conv (*k, I/g, O)."""
    return _linear(k) if np.ndim(k) == 2 else _conv(k)


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


def _kernel_inv(w):
    return _linear(w) if np.ndim(w) == 2 else _conv_inv(w)


_INVERSE = {_linear: _linear, _identity: _identity,
            _audio_stem_linear: _audio_stem_linear_inv, _convt: _convt_inv,
            _kernel: _kernel_inv}


def _leaf_rule(segs: List[str], leaf: str, in_batch_stats: bool):
    parent = segs[-1] if segs else ""
    if in_batch_stats:
        return {"mean": "running_mean", "var": "running_var"}[leaf], _identity
    if leaf in ("scale", "bias"):
        return ("weight" if leaf == "scale" else "bias"), _identity
    if leaf == "kernel":
        if parent == "linear":
            return "weight", _audio_stem_linear
        if _CONVT_RE.match(parent):
            return "weight", _convt
        return "weight", _kernel
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
            elif segs[i + 1] in _RESNET_STEM:
                out.append("front_end.3." + _RESNET_STEM[segs[i + 1]])
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
        elif s == "LayerNorm_0" and (prev in ("transformer", "block")
                                     or _BLOCK_RE.match(prev)):
            out.append("layernorm" if prev == "transformer" else "norm")
            i += 1
        elif (s == "GroupNorm_0" and i == len(segs) - 1
              and (i == 0 or _GROUPNORM_RE.match(prev))):
            i += 1              # the flax GroupNorm inside the JAX wrapper
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


def _resnet_root(paths) -> bool:
    """Whether the trees are a ResNet's at the root (resnet.py:120)."""
    return any(segs[0] in _RESNET_STEM
               or (_BLOCK_RE.match(segs[0]) and len(segs) > 2
                   and segs[1] in _RESNET_IDX) for segs in paths)


def _lstm_entries(cells: Dict[Tuple[str, ...], Dict[int, dict]],
                  bidirectional) -> "OrderedDict[str, np.ndarray]":
    """{prefix: {K: cell tree}} -> the LSTM's torch entries by key."""
    out = OrderedDict()
    for prefix, by_k in cells.items():
        n = len(by_k)
        hid = by_k[0]["hi"]["kernel"].shape[0]
        dims = [by_k[k]["ii"]["kernel"].shape[0] for k in sorted(by_k)]
        bidir = bidirectional
        if bidir is None:
            if n % 2:
                bidir = False
            elif n >= 4:
                bidir = dims[2] == 2 * hid
            elif dims[1] != dims[0]:
                bidir = False
            elif dims[0] != hid:
                bidir = True
            else:
                raise ValueError("a 2-cell LSTM with input size == hidden "
                                 "size is one bidirectional layer or two "
                                 "layers: pass bidirectional_lstm")
        ndir = 2 if bidir else 1
        base = _map_segments(list(prefix), {})
        base = base + "." if base else ""
        for k, cell in sorted(by_k.items()):
            sfx = f"_l{k // ndir}" + ("_reverse" if k % ndir else "")
            w_ih = np.concatenate([np.asarray(cell["i" + g]["kernel"]).T
                                   for g in _LSTM_GATES])
            w_hh = np.concatenate([np.asarray(cell["h" + g]["kernel"]).T
                                   for g in _LSTM_GATES])
            b_hh = np.concatenate([np.asarray(cell["h" + g]["bias"])
                                   for g in _LSTM_GATES])
            out[base + "weight_ih" + sfx] = w_ih
            out[base + "weight_hh" + sfx] = w_hh
            out[base + "bias_ih" + sfx] = np.zeros_like(b_hh)
            out[base + "bias_hh" + sfx] = b_hh
    return out


def params_from_jax(params, batch_stats=None, bidirectional_lstm=None
                    ) -> "OrderedDict[str, torch.Tensor]":
    """JAX `params` / `batch_stats` trees -> the port's state_dict.
    `bidirectional_lstm` settles the one layout the cells cannot tell
    (two cells whose input size equals the hidden size)."""
    leaves = [(segs, arr, False) for segs, arr in _flatten(params).items()]
    leaves += [(segs, arr, True)
               for segs, arr in _flatten(batch_stats or {}).items()]
    cells: Dict[Tuple[str, ...], Dict[int, dict]] = {}
    plain = []
    for segs, arr, in_bs in leaves:
        j = next((j for j, seg in enumerate(segs) if _LSTM_RE.match(seg)),
                 None)
        if j is None:
            plain.append((segs, arr, in_bs))
            continue
        node = cells.setdefault(segs[:j], {}).setdefault(
            int(_LSTM_RE.match(segs[j]).group(1)), {})
        node.setdefault(segs[j + 1], {})[segs[-1]] = arr
    root = _resnet_root([segs for segs, _, _ in plain])
    if root:
        plain = [(("front_end_resnet",) + segs, arr, in_bs)
                 for segs, arr, in_bs in plain]
    ordinals = _interctc_ordinals([segs for segs, _, _ in plain])
    sd = OrderedDict()
    for segs, arr, in_bs in plain:
        segs, leaf = list(segs[:-1]), segs[-1]
        entries = _torch_entries(segs, leaf, in_bs, ordinals)
        slices = [arr] if len(entries) == 1 else list(arr)
        for (key, tf), a in zip(entries, slices):
            if root:
                key = key[len(_RESNET_ROOT):]
            sd[key] = torch.from_numpy(
                np.ascontiguousarray(tf(a), dtype=np.float32))
    for key, a in _lstm_entries(cells, bidirectional_lstm).items():
        sd[key] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
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
    their structure is read. (An LSTM's cells have no inverse here.)"""
    paths = _flatten_paths(params_template)
    paths += _flatten_paths(batch_stats_template or {})
    if _resnet_root(paths):
        wrap = lambda tree: {"front_end_resnet": tree} if tree else tree
        values = {_RESNET_ROOT + k: v for k, v in values.items()}
        params, stats = state_to_jax(values, wrap(params_template),
                                     wrap(batch_stats_template or {}))
        return (params["front_end_resnet"],
                stats.get("front_end_resnet", {}))
    ordinals = _interctc_ordinals([p[:-1] for p in paths])
    params = _tree_to_jax(values, params_template, False, ordinals)
    stats = _tree_to_jax(values, batch_stats_template or {}, True, ordinals)
    return params, stats


def grads_to_jax_layout(grads, params_template):
    """Gradients by parameter name -> a tree shaped like the JAX `params`."""
    return state_to_jax(grads, params_template)[0]
