"""Shared helpers for the PyTorch-port tests, and the port's purity tests.

The port (`avec_tpu_torch`) must import neither JAX nor `avec_tpu`; only
these tests import both. Inputs and weights are made with numpy from a seed:
JAX variables are drawn for a flax module's parameter shapes and carried into
the port with `avec_tpu_torch.convert.params_from_jax`.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from avec_tpu_torch.convert import params_from_jax

REPO = Path(__file__).resolve().parents[1]


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (copied)."""
    return torch.from_numpy(np.array(a))


def _draw(path, shape, rng):
    name = path[-1]
    if name == "mean":
        return rng.randn(*shape) * 0.1
    if name == "var":
        return rng.rand(*shape) + 0.5
    if name == "scale":
        return 1.0 + rng.randn(*shape) * 0.1
    if name in ("bias", "pos_bias"):
        return rng.randn(*shape) * 0.1
    stacked = any(p.startswith("blocks_") for p in path)
    fan_in = int(np.prod(shape[1 if stacked else 0:-1]))
    bound = 1.0 / np.sqrt(max(fan_in, 1))
    return rng.uniform(-bound, bound, size=shape)


def random_variables(shapes, seed: int = 0):
    """Seeded numpy values for a flax variables shape tree (from
    jax.eval_shape of `init`): torch-default-scale weights, non-trivial
    norm affines and BN running statistics."""
    rng = np.random.RandomState(seed)
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = {}
    for path, leaf in paths:
        keys = [p.key for p in path]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _draw(keys[1:], leaf.shape, rng).astype(np.float32)
    return out.get("params", {}), out.get("batch_stats", {})


def init_variables(module, *args, seed: int = 0, **kwargs):
    """Random (params, batch_stats) for a flax module without compiling its
    init: eval_shape gives the shapes, numpy draws the values."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args,
                            **kwargs))
    return random_variables(shapes, seed)


def port_state(params, batch_stats=None, wrap=None, strip=""):
    """params_from_jax, optionally wrapping the trees in a scope name (so the
    path rules see the module's place in a model) and stripping the
    resulting key prefix."""
    if wrap:
        params = {wrap: params}
        batch_stats = {wrap: batch_stats} if batch_stats else None
    sd = params_from_jax(params, batch_stats)
    return {k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}


def _port_files():
    files = sorted((REPO / "avec_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "tools").glob("torch_*.py"))
    smoke = REPO / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def test_port_imports_no_jax():
    """Importing the port pulls in neither jax nor avec_tpu (run in a fresh
    interpreter: this test process already imported JAX)."""
    code = ("import sys, avec_tpu_torch, avec_tpu_torch.serve, "
            "avec_tpu_torch.convert, avec_tpu_torch.ops.ffn, "
            "avec_tpu_torch.train.model, avec_tpu_torch.train.losses, "
            "avec_tpu_torch.train.optim, avec_tpu_torch.train.schedulers, "
            "avec_tpu_torch.parallel.dist, avec_tpu_torch.train.checkpoint, "
            "avec_tpu_torch.train.metrics, avec_tpu_torch.utils.wer, "
            "avec_tpu_torch.utils.tokenizer, avec_tpu_torch.data.dataset, "
            "avec_tpu_torch.data.collate, avec_tpu_torch.data.synthetic, "
            "avec_tpu_torch.data.loader, avec_tpu_torch.decode.greedy, "
            "avec_tpu_torch.configs.av_tone, avec_tpu_torch.decode.beam, "
            "avec_tpu_torch.decode.native, avec_tpu_torch.decode.ngram, "
            "avec_tpu_torch.decode.device_beam, avec_tpu_torch.configs.lm_tone, "
            "avec_tpu_torch.models.transformer, avec_tpu_torch.data.corpus_lm, "
            "avec_tpu_torch.utils.spm_model, avec_tpu_torch.utils.flac, "
            "avec_tpu_torch.utils.media, avec_tpu_torch.data.transforms, "
            "avec_tpu_torch.demo, avec_tpu_torch.decode.streaming, "
            "avec_tpu_torch.decode.causal_streaming, avec_tpu_torch.main, "
            "avec_tpu_torch.cli.functions, avec_tpu_torch.utils.logging, "
            "avec_tpu_torch.data.lipcrop, avec_tpu_torch.data.lrs, "
            "avec_tpu_torch.data.lrw, avec_tpu_torch.data.datasets, "
            "avec_tpu_torch.data.lrs_fixture, avec_tpu_torch.configs.common, "
            "avec_tpu_torch.configs.lrs23_av, avec_tpu_torch.configs.lrs23_ao, "
            "avec_tpu_torch.configs.lrs23_vo, "
            "avec_tpu_torch.configs.lrs23_lm_gpt_small, "
            "avec_tpu_torch.configs.lrs23_lm_gpt_small_demo, "
            "avec_tpu_torch.configs.librispeech_gpt_small, "
            "avec_tpu_torch.ops.rnnt, avec_tpu_torch.ops.pca, "
            "avec_tpu_torch.ops.inits, avec_tpu_torch.ops.module_utils, "
            "avec_tpu_torch.ops.variational_noise, avec_tpu_torch.ops.ctc, "
            "avec_tpu_torch.ops.activations\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'avec_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_source_has_no_jax_reference(path):
    """No import of jax/flax and no import of `avec_tpu` (as opposed to
    `avec_tpu_torch`), in any statement form, in any port source, in the
    port's tools (tools/torch_*.py) or in chip_smoke.py. Docstrings may still name the JAX file a module ports."""
    src = path.read_text()
    mod = r"(jax|jaxlib|flax|avec_tpu(?!_torch))\b"
    assert not re.search(r"^\s*(import|from)\s+" + mod, src, re.M), path
    assert not re.search(r"import\s+[\w., ]*\b" + mod, src), path
    assert not re.search(r"(import_module|__import__)\(\s*['\"]" + mod, src), path


def test_entry_points_default_to_cuda(tmp_path):
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
    from avec_tpu_torch.serve import Server

    with pytest.raises(RuntimeError, match="CUDA"):
        AudioVisualEfficientConformerInterCTC(vocab_size=8, v_num_blocks=(1, 1),
                                              a_num_blocks=(1, 1, 1),
                                              f_num_blocks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(vocab_size=8)
    from avec_tpu_torch.train.model import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(vocab_size=8)
    from avec_tpu_torch.configs import av_tone, lm_tone
    from avec_tpu_torch.decode.device_beam import CTCDeviceBeamSearchDecoder
    from avec_tpu_torch.models.zoo import GPT

    with pytest.raises(RuntimeError, match="CUDA"):
        av_tone.build(str(tmp_path / "av_tone"))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_tone.build(str(tmp_path / "lm_tone"))
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT(model="GPT-Tiny", vocab_size=8)
    tok = str(tmp_path / "tok.json")
    lm_tone.tokenizer.save(tok)
    with pytest.raises(RuntimeError, match="CUDA"):
        CTCDeviceBeamSearchDecoder(tok)


def test_import_scan_covers_the_training_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"avec_tpu_torch/ops/ffn.py", "avec_tpu_torch/train/model.py",
            "avec_tpu_torch/train/losses.py", "avec_tpu_torch/train/optim.py",
            "avec_tpu_torch/train/schedulers.py",
            "avec_tpu_torch/parallel/__init__.py",
            "avec_tpu_torch/parallel/dist.py", "chip_smoke.py",
            "avec_tpu_torch/train/checkpoint.py",
            "avec_tpu_torch/train/metrics.py", "avec_tpu_torch/utils/wer.py",
            "avec_tpu_torch/utils/tokenizer.py",
            "avec_tpu_torch/data/dataset.py", "avec_tpu_torch/data/collate.py",
            "avec_tpu_torch/data/synthetic.py", "avec_tpu_torch/data/loader.py",
            "avec_tpu_torch/configs/av_tone.py",
            "tools/torch_av_tone_routes.py",
            "avec_tpu_torch/decode/beam.py", "avec_tpu_torch/decode/native.py",
            "avec_tpu_torch/decode/ngram.py",
            "avec_tpu_torch/decode/device_beam.py",
            "avec_tpu_torch/configs/lm_tone.py",
            "avec_tpu_torch/models/transformer.py",
            "avec_tpu_torch/data/corpus_lm.py",
            "avec_tpu_torch/utils/spm_model.py",
            "avec_tpu_torch/utils/flac.py", "avec_tpu_torch/utils/media.py",
            "avec_tpu_torch/data/transforms.py", "avec_tpu_torch/demo.py",
            "avec_tpu_torch/decode/streaming.py",
            "avec_tpu_torch/decode/causal_streaming.py",
            "avec_tpu_torch/serve.py", "avec_tpu_torch/main.py",
            "avec_tpu_torch/cli/__init__.py",
            "avec_tpu_torch/cli/functions.py",
            "avec_tpu_torch/utils/logging.py",
            "avec_tpu_torch/data/lipcrop.py", "avec_tpu_torch/data/lrs.py",
            "avec_tpu_torch/data/lrw.py", "avec_tpu_torch/data/datasets.py",
            "avec_tpu_torch/data/lrs_fixture.py",
            "avec_tpu_torch/configs/common.py",
            "avec_tpu_torch/configs/lrs23_av.py",
            "avec_tpu_torch/configs/lrs23_ao.py",
            "avec_tpu_torch/configs/lrs23_vo.py",
            "avec_tpu_torch/configs/lrs23_lm_gpt_small.py",
            "avec_tpu_torch/configs/lrs23_lm_gpt_small_demo.py",
            "avec_tpu_torch/configs/librispeech_gpt_small.py",
            "avec_tpu_torch/ops/rnnt.py", "avec_tpu_torch/ops/pca.py",
            "avec_tpu_torch/ops/inits.py",
            "avec_tpu_torch/ops/module_utils.py",
            "avec_tpu_torch/ops/variational_noise.py",
            "avec_tpu_torch/__init__.py"} <= names
