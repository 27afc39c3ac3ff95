"""The argument-level surface of the port against the JAX package, read
with `ast` (neither package is imported).

For every public top-level function and class of `avec_tpu/` whose name is
also a top-level function or class of `avec_tpu_torch/`, each JAX parameter
(a function's arguments; a class's own `__init__` arguments and flax fields,
the annotated names of its body) must be an argument or field of the port's
namesake (any of them, where several modules define the name; a port class
without its own `__init__` takes its bases'). The only exceptions are
written below with a reason each:

* RENAMED: the port names the same argument as PyTorch does; the port name
  must exist;
* TPU_ONLY: arguments that choose a TPU lowering, a Pallas tiling or
  interpret mode, a JAX mesh or axis, flax / optax plumbing, or that the
  JAX package declares and never reads. None of them changes the function
  a module computes.

Call arguments (`__call__`) are not compared: `deterministic` / `training`
are the port module's `.train()` / `.eval()`, and the tensors are the same
by position.
"""

import ast
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

RENAMED = {
    # PyTorch's names for the layer arguments
    "Conv.features": "out_ch", "Conv.strides": "stride",
    "Conv.use_bias": "bias",
    "ConvTranspose.features": "out_ch", "ConvTranspose.strides": "stride",
    "ConvTranspose.use_bias": "bias",
    "Linear.features": "out_features", "Linear.use_bias": "bias",
    "BatchNorm.epsilon": "eps", "LayerNorm.epsilon": "eps",
    "glu.axis": "dim", "tanh_glu.axis": "dim",
    # the "pallas" stem is FusedVideoStem(mode="pallas")
    "FusedVideoStem.use_pallas": "mode",
    # the fused kernels' parameters by the port's names (Linear / Conv
    # weights in PyTorch's layout)
    "fused_ffn.scale": "ln_w", "fused_ffn.bias": "ln_b",
    "fused_ffn_3d.scale": "ln_w", "fused_ffn_3d.bias": "ln_b",
    "fused_ffn_3d_dp.scale": "ln_w", "fused_ffn_3d_dp.bias": "ln_b",
    **{f"{fn}.{a}": b for fn in ("fused_attention_module_3d",
                                 "fused_attention_module_3d_dp")
       for a, b in (("ln_scale", "ln_w"), ("ln_bias", "ln_b"),
                    ("pos_kernel", "pos_weight"))},
    **{f"{fn}.{a}": b for fn in ("fused_conv_module_3d",
                                 "fused_conv_module_3d_dp")
       for a, b in (("ln_scale", "ln_w"), ("ln_bias", "ln_b"),
                    ("pw1_kernel", "pw1_w"), ("pw1_bias", "pw1_b"),
                    ("dw_kernel", "dw_w"), ("dw_bias", "dw_b"),
                    ("bn_scale", "bn_w"), ("bn_bias", "bn_b"),
                    ("pw2_kernel", "pw2_w"), ("pw2_bias", "pw2_b"))},
    **{f"{fn}.bias": "conv_bias" for fn in ("fused_stem_eval",
                                            "fused_stem_train")},
    # a torch.Generator in place of a JAX key
    "sample_synaptic_noise.rng": "generator",
    # torch.distributed's names for the process group
    "init_distributed.coordinator_address": "init_method",
    "init_distributed.num_processes": "world_size",
    "init_distributed.process_id": "rank",
    # the port's optimizers and shardings read the nn.Module, not a tree
    "gpt_decay_mask.params": "model",
    "param_shardings.params": "module",
    "shard_tree.tree": "state",
}

TPU_ONLY = {
    "ConformerInterCTC.unroll_blocks":
        "lax.scan unroll of the scanned block runs: the port has no scan",
    "Conv.polyphase": "space-to-depth lowering of a strided conv for the "
                      "MXU; same outputs (layers.py:115-240)",
    "Conv.spatial_swap": "keeps the stored kernel layout under a "
                         "time-major TPU stem; same function",
    "ConvNeuralNetwork.polyphase": "as Conv.polyphase",
    "ConvNeuralNetwork.spatial_swap": "as Conv.spatial_swap",
    "RelPos1dMultiHeadAttention.factorized":
        "the skew or the exact sin/cos factorization of the same scores; "
        "the port always factorizes (causal takes the skew, as in JAX)",
    "RelPos1dMultiHeadAttention.num_pos_embeddings":
        "declared and never read: both packages build the table per length",
    "DeviceNgramTables.vocab_size": "declared and never read "
                                    "(device_beam.py:85)",
    "BatchNorm.use_running_average":
        "flax's module-level switch: the port's .train() / .eval()",
    "FusedVideoStem.interpret": "Pallas interpret mode (CPU tests)",
    "VisualEfficientConformerEncoder.stem_interpret":
        "Pallas interpret mode of the stem (CPU tests)",
    "bn_relu_pool.interpret": "Pallas interpret mode",
    "bn_relu_pool.tb2": "the Pallas kernel's time-block size",
    "flash_attention.interpret": "Pallas interpret mode",
    "flash_attention.block_q": "the Pallas kernel's query tile",
    "flash_attention.block_k": "the Pallas kernel's key tile",
    "rel_pos_flash_attention.interpret": "Pallas interpret mode",
    **{f"{fn}.interpret": "Pallas interpret mode"
       for fn in ("fused_ffn", "fused_ffn_3d", "fused_ffn_3d_dp",
                  "fused_attention_module_3d",
                  "fused_attention_module_3d_dp", "fused_conv_module_3d",
                  "fused_conv_module_3d_dp", "fused_stem_eval",
                  "fused_stem_train")},
    **{f"{fn}.{a}": "a JAX mesh / axis name for shard_map: the port's DP "
                    "forms take a process group"
       for fn in ("fused_ffn_3d_dp", "fused_attention_module_3d_dp",
                  "fused_conv_module_3d_dp") for a in ("mesh", "axis")},
    **{f"{fn}.{a}": "the TPU stem's polyphase-folded input and kernel and "
                    "its padded time count; the port's stem takes x and "
                    "the conv weight"
       for fn in ("fused_stem_eval", "fused_stem_train")
       for a in ("xp", "kp2", "t_valid")},
    "make_mesh.devices": "a list of JAX devices: the port's mesh is the "
                         "process group's ranks",
    "shard_batch.mesh": "a JAX mesh: the port shards over the process group",
    "shard_batch.batch_axis": "a JAX sharding axis: the port cuts axis 0",
    "shard_like_params.params": "a JAX tree of sharded arrays: the port "
                                "places by the module's shards",
    "shard_like_params.shardings": "JAX NamedShardings, as above",
    "harvest_aux_losses.collections": "flax variable collections: the "
                                      "port's modules hold their records",
    "harvest_infos.collections": "flax variable collections, as above",
    "Optimizer.tx": "the optax transformation: the port wraps a "
                    "torch.optim optimizer",
    "Optimizer.name": "the optax optimizer's name, as above",
    **{f"{fn}.params": "accepted for API parity and never read "
                       "(optim.py:35-90)"
       for fn in ("SGD", "Adam", "AdamW", "RMSprop")},
}


def _args(fn: ast.FunctionDef):
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} - {
        "self", "cls"}


def _surface(root: Path):
    """{name: [(file:line, arguments, base names, has __init__)]} of the
    tree's top-level functions and classes."""
    out = defaultdict(list)
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        where = lambda node: f"{path.relative_to(REPO)}:{node.lineno}"
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                out[node.name].append((where(node), _args(node), [], True))
            elif isinstance(node, ast.ClassDef):
                names, has_init = set(), False
                for item in node.body:
                    if (isinstance(item, ast.AnnAssign)
                            and isinstance(item.target, ast.Name)):
                        names.add(item.target.id)
                    elif (isinstance(item, ast.FunctionDef)
                          and item.name == "__init__"):
                        names |= _args(item)
                        has_init = True
                bases = [b.id if isinstance(b, ast.Name) else
                         getattr(b, "attr", "") for b in node.bases]
                out[node.name].append((where(node), names, bases, has_init))
    return out


def _port_arguments(port, name, seen=()):
    """The union of the arguments of the port's definitions of `name`, a
    class without its own __init__ taking its bases'."""
    args = set()
    for _, names, bases, has_init in port.get(name, []):
        args |= names
        if not has_init:
            for base in bases:
                if base not in seen:
                    args |= _port_arguments(port, base, seen + (name,))
    return args


def test_the_port_has_every_argument_of_the_jax_package():
    jax_side = _surface(REPO / "avec_tpu")
    port = _surface(REPO / "avec_tpu_torch")
    missing, stale_renames = [], []
    used = set()
    for name, defs in sorted(jax_side.items()):
        if name.startswith("_") or name not in port:
            continue
        have = _port_arguments(port, name)
        for where, args, _, _ in defs:
            for arg in sorted(args - have):
                key = f"{name}.{arg}"
                used.add(key)
                if key in TPU_ONLY:
                    continue
                if key in RENAMED:
                    if RENAMED[key] not in have:
                        stale_renames.append(f"{where} {key} -> "
                                             f"{RENAMED[key]}")
                    continue
                missing.append(f"{where} {key}")
    assert not missing, "JAX arguments the port lacks:\n" + "\n".join(missing)
    assert not stale_renames, "\n".join(stale_renames)
    # every exception still names an argument the port lacks
    assert not (set(RENAMED) | set(TPU_ONLY)) - used, sorted(
        (set(RENAMED) | set(TPU_ONLY)) - used)


def test_the_allowlist_has_a_reason_for_each_entry():
    assert all(isinstance(r, str) and len(r) > 10 for r in TPU_ONLY.values())
    assert not set(RENAMED) & set(TPU_ONLY)


def test_the_surface_covers_the_options_of_this_library():
    """The walk sees the options the port took over from the JAX package
    (the name-only comparison missed them)."""
    port = _surface(REPO / "avec_tpu_torch")
    for name, arg in (("ConformerInterCTC", "remat"),
                      ("ConformerBlock", "transposed"),
                      ("ConvolutionModule", "batch_norm"),
                      ("FeedForwardModule", "prenorm"),
                      ("AttentionModule", "residual"),
                      ("Transformer", "post_norm"), ("GPTNet", "compute_dtype"),
                      ("ResNetBlock", "joined_post_act"),
                      ("ConvNeuralNetwork", "norm"),
                      ("MultiHeadAttention", "output_proj"),
                      ("BatchNorm", "frozen"),
                      ("power_spectrogram", "win_length"),
                      ("NativeBeamDecoder", "cutoff_prob"),
                      ("save_checkpoint", "extra"), ("CorpusLM", "download"),
                      ("AudioVisualEfficientConformerInterCTC", "remat")):
        assert arg in _port_arguments(port, name), (name, arg)
