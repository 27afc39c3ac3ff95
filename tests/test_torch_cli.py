"""The port's experiment CLI (`python -m avec_tpu_torch.main`) vs the JAX
package's (the root main.py and the configs under configs/).

  * `-m pass --cpu` for every port config that follows a JAX config, run
    in a directory without datasets/ (so both take their synthetic
    fallback): the parameter count `summary` prints equals the JAX config
    model's (from `jax.eval_shape` of its init), every setting the two
    configs share by name is equal, and the datasets give the same samples
    in the same sizes;
  * without `--cpu` on a machine without CUDA the CLI raises;
  * a tone config cut to a small size (the AO-Tone setup, blocks (1, 1, 1),
    B=2, fp32, greedy decoding) trained for 2 steps through
    `python -m avec_tpu_torch.main --cpu`, then `--load_last` training on
    from its epoch, evaluation (with `--profile`), swa and eval_time
    in-process through `main.main(argv)`;
  * `-d` with two gloo ranks of that config for 2 steps, dropout and
    SpecAugment off: each rank trains on its own shard of the global batch,
    both log the same global losses, and the losses and the checkpoint
    follow one process of the config trained on the same global batches.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from avec_tpu_torch import main as cli
from avec_tpu_torch.cli.functions import get_open_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread a process: two gloo ranks on every core take 10x longer
ENV = dict(os.environ, PYTHONPATH=REPO, AVEC_TPU_LOG_FORMAT="jsonl",
           OMP_NUM_THREADS="1")

torch.set_num_threads(1)

# port config -> the JAX config it follows
PAIRS = {
    "lrs23_av": "configs/LRS23/AV/EffConfInterCTC.py",
    "lrs23_ao": "configs/LRS23/AO/EffConfCTC.py",
    "lrs23_vo": "configs/LRS23/VO/EffConfInterCTC.py",
    "lrs23_lm_gpt_small": "configs/LRS23/LM/GPT-Small.py",
    "lrs23_lm_gpt_small_demo": "configs/LRS23/LM/GPT-Small-demo.py",
    "librispeech_gpt_small": "configs/LibriSpeechCorpus/GPT-Small.py",
    "lrw": "configs/LRW/EffConfCE.py",
}
SIMPLE = (int, float, str, bool, type(None), list, tuple, dict)

TINY = '''
from avec_tpu_torch.configs import ao_tone
from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder

callback_path = "callbacks/tiny"


def build(callback_path=callback_path, device="cuda", data_parallel=False):
    return ao_tone.build(callback_path, device=device, precision="float32",
                         batch_size=2, train_samples=8, eval_samples=4,
                         decoder=CTCGreedySearchDecoder,
                         data_parallel=data_parallel, num_blocks=(1, 1, 1),
                         interctc_blocks=(1,))
'''


def _jax_config(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_cfg_" + rel.replace("/", "_").replace("-", "_")[:-3],
        os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_params(cfg) -> int:
    ds = cfg.training_dataset
    batch = ds.collate_fn([ds[0], ds[1]])
    args = cfg.model.net_inputs(batch["inputs"])
    shapes = jax.eval_shape(lambda: cfg.model.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        shapes["params"]))


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("name,flags", [
    *(pytest.param(n, [], id=n) for n in sorted(PAIRS)),
    pytest.param("lrs23_lm_gpt_small", ["--no_eval_training"],
                 id="lrs23_lm_gpt_small-no_eval_training")])
def test_pass_mode_matches_the_jax_config(name, flags, tmp_path, monkeypatch,
                                          capsys):
    monkeypatch.chdir(tmp_path)
    path = os.path.join(REPO, "avec_tpu_torch", "configs", name + ".py")
    args = cli.main(["-c", path, "-m", "pass", "--cpu"] + flags)
    out = capsys.readouterr().out
    assert "Mode: pass" in out
    count = int(out.split("Number Parameters: ")[1].split()[0]
                .replace(",", ""))
    jcfg = _jax_config(PAIRS[name])
    assert count == _jax_params(jcfg) == args.setup.trainer.num_params()

    port = args.config
    shared = [k for k, v in vars(jcfg).items()
              if not k.startswith("__") and isinstance(v, SIMPLE)
              and hasattr(port, k) and isinstance(getattr(port, k), SIMPLE)]
    assert {"batch_size", "callback_path"} <= set(shared) or name == "lrw"
    for k in shared:
        assert _equal(getattr(port, k), getattr(jcfg, k)), k
    setup = args.setup
    assert setup.callback_path == jcfg.callback_path == args.callback_path
    for key in ("precision", "accumulated_steps", "eval_training",
                "recompute_metrics", "epochs"):
        if hasattr(jcfg, key):
            assert getattr(setup, key) == getattr(jcfg, key), key
    # what fit gets, as the root main.py:102-103 reads it
    assert args.eval_training == getattr(
        jcfg, "eval_training", "--no_eval_training" not in flags)
    jt, je = jcfg.training_dataset, jcfg.evaluation_dataset
    pt, pe = setup.training_dataset, setup.evaluation_dataset
    je, pe = (je, pe) if isinstance(je, list) else ([je], [pe])
    for j, p in [(jt, pt)] + list(zip(je, pe)):
        assert (len(p), p.batch_size, type(p).__name__) == (
            len(j), j.batch_size, type(j).__name__)
        for i in (0, len(j) - 1):
            assert _equal(list(p[i]), list(j[i])), (type(p).__name__, i)
        assert _equal(j.collate_fn([j[0], j[1]])["targets"],
                      p.collate_fn([p[0], p[1]])["targets"])


def test_without_cpu_and_without_cuda_the_cli_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    res = subprocess.run(
        [sys.executable, "-m", "avec_tpu_torch.main", "-c",
         os.path.join(REPO, "avec_tpu_torch/configs/lrs23_ao.py"), "-m",
         "pass"], cwd=tmp_path, env=ENV, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
    assert "Number Parameters" not in res.stdout


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_tone_config_trains_then_every_mode(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY)
    res = subprocess.run(
        [sys.executable, "-m", "avec_tpu_torch.main", "-c", str(cfg), "-m",
         "training", "--cpu", "--steps_per_epoch", "2", "--epochs", "1",
         "--eval_steps", "1", "--step_log_period", "1"],
        cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Epoch 1/1:" in res.stdout and "Model saved at step 2" in res.stdout
    cb = tmp_path / "callbacks" / "tiny"
    assert (cb / "checkpoints_epoch_1_step_2.ckpt").is_file()
    tags = {r["tag"] for r in _events(cb / "logs" / "events.jsonl")}
    assert {"Training-step/loss", "Training-epoch/loss",
            "Evaluation-epoch/0/loss", "Evaluation-epoch/0/wer"} <= tags

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("AVEC_TPU_LOG_FORMAT", "jsonl")
    base = ["-c", str(cfg), "--cpu", "--eval_steps", "1"]
    cli.main(base + ["-m", "training", "--load_last", "--epochs", "2",
                     "--steps_per_epoch", "1"])
    out = capsys.readouterr().out
    assert "Model loaded at step 2" in out and "Epoch 1/2" not in out
    assert "Epoch 2/2:" in out and "Model saved at step 3" in out
    cli.main(base + ["-m", "evaluation", "--load_last", "--profile"])
    out = capsys.readouterr().out
    assert "Model loaded at step 3" in out and "eval wer:" in out
    assert (cb / "profile" / "trace_rank0.json").is_file()
    cli.main(base + ["-m", "swa", "--swa_epochs", "1", "2",
                     "--steps_per_epoch", "1"])
    out = capsys.readouterr().out
    assert "Stochastic Weight Averaging on checkpoints : [1, 2]" in out
    assert (cb / "checkpoints_swa-equal-1-2.ckpt").is_file()
    cli.main(base + ["-m", "eval_time", "-i", "checkpoints_swa-equal-1-2"
                     ".ckpt"])
    out = capsys.readouterr().out
    times = out.split("Eval time: ")[1]
    assert all(k in times for k in ("'mean'", "'std'", "'min'", "'max'"))


# the tiny config with dropout and SpecAugment off: each rank draws its own
# masks, so only then does the two-rank run follow one process on the same
# global batches
TINY_NO_REGULARIZATION = TINY + '''

_build = build


def build(callback_path=callback_path, device="cuda", data_parallel=False):
    setup = _build(callback_path, device, data_parallel)
    setup.trainer.model.set_regularization(False)
    return setup
'''


def _rank_loaders(setup, monkeypatch, world=2):
    """The CLI's training loader of each rank, built by `_make_loader` as
    rank r of `world` would build it."""
    from avec_tpu_torch.cli import functions

    args = argparse.Namespace(setup=setup, num_workers=0)
    loaders = []
    for r in range(world):
        monkeypatch.setattr(functions.pdist, "world_size", lambda: world)
        monkeypatch.setattr(functions.pdist, "rank", lambda r=r: r)
        loaders.append(functions._make_loader(setup.training_dataset, args,
                                              drop_last=True))
    return loaders


def test_two_gloo_ranks_train_data_parallel(tmp_path, monkeypatch):
    """Two ranks through the CLI against one process of the same config
    trained on the same global batches (the two ranks' loader shards
    together; the tone samples have one padded shape, so rank-local padding
    equals the global one), with the DP step tests' tolerances: the logged
    step losses within 1e-4 relative; after 2 steps, Adam's first moment of
    every parameter (linear in the two steps' global gradients) within 2e-3
    of its leaf's largest entry plus 1e-7, and every BN statistic within
    1e-5. The parameters as a whole: the norm of their difference within
    1e-2 of the norm of their change (1.2e-3 here: an entry whose gradient
    is near 0 takes a full Adam step of either sign, so no entrywise bound
    holds; other batches move them O(1)).
    Each rank's shards are disjoint from the other's and together are the
    batches of a one-rank loader twice the size."""
    from avec_tpu_torch.data.loader import DataLoader
    from avec_tpu_torch.decode.beam import import_config
    from avec_tpu_torch.train.checkpoint import load_checkpoint

    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY_NO_REGULARIZATION)
    port = get_open_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "avec_tpu_torch.main", "-c", str(cfg), "-m",
         "training", "--cpu", "-d", "--coordinator", f"localhost:{port}",
         "--num_processes", "2", "--process_id", str(r), "--dist_log",
         "--steps_per_epoch", "2", "--epochs", "1", "--eval_steps", "1",
         "--step_log_period", "1"], cwd=tmp_path, env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "batch size 2" in outs[0][0] and "Model saved at step 2" in outs[0][0]
    cb = tmp_path / "callbacks" / "tiny"
    assert (cb / "checkpoints_epoch_1_step_2.ckpt").is_file()
    losses = []
    for r in range(2):
        rows = _events(cb / "logs" / f"events_rank{r}.jsonl")
        assert rows and all(f"-{r}/" in row["tag"] for row in rows)
        losses.append([row["value"] for row in rows
                       if row["tag"] == f"Training-step-{r}/loss"])
    assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)

    # one process, the same config, on the global batches of those steps
    monkeypatch.chdir(tmp_path)
    setup = import_config(str(cfg)).build(str(tmp_path / "ref"), device="cpu")
    ds = setup.training_dataset
    shards = [loader._batch_index_chunks()[:2]
              for loader in _rank_loaders(setup, monkeypatch)]
    whole = DataLoader(ds, batch_size=2 * ds.batch_size,
                       drop_last=True)._batch_index_chunks()[:2]
    trainer = setup.trainer
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for step, (a, b, g) in enumerate(zip(*shards, whole)):
        assert len(a) == len(b) == ds.batch_size
        assert not set(a) & set(b) and set(a) | set(b) == set(g)
        batch = ds.collate_fn([ds[int(i)] for i in list(a) + list(b)])
        got, _ = trainer.train_step(batch)
        assert losses[0][step] == pytest.approx(float(got["loss"]),
                                                rel=1e-4), step
    ckpt = load_checkpoint(str(cb / "checkpoints_epoch_1_step_2.ckpt"))
    state, want = ckpt["model_state_dict"], trainer.model.state_dict()
    assert state.keys() == want.keys()
    params = dict(trainer.model.named_parameters())
    for k, w in want.items():
        if k not in params and w.is_floating_point():
            assert float((state[k] - w).abs().max()) <= 1e-5, k
        elif k not in params:
            assert torch.equal(state[k], w), k
    diff = sum(float(((state[k] - w) ** 2).sum()) for k, w in want.items()
               if k in params)
    change = sum(float(((w - init[k]) ** 2).sum()) for k, w in want.items()
                 if k in params)
    assert diff ** 0.5 <= 1e-2 * change ** 0.5, (diff, change)
    got_m = ckpt["optimizer_state_dict"]["state"]
    want_m = trainer.optimizer.optimizer.state_dict()["state"]
    assert len(got_m) == len(want_m) == len(params)
    for i, name in enumerate(params):
        g, w = got_m[i]["exp_avg"], want_m[i]["exp_avg"]
        err = float((g - w).abs().max())
        assert err <= 2e-3 * float(w.abs().max()) + 1e-7, (name, err)
