"""Two gloo ranks of the port's CLI (`python -m avec_tpu_torch.main -d`) on
ragged utterances: the audio-only model (patch attention, blocks (1, 1, 1),
vocab 256, B=2 a rank, fp32, dropout and SpecAugment off) trained for 2
steps from a seeded LRS2 + LRS3 tree (`data/lrs_fixture.py`: utterances of
1-3 s). Each rank's length-bucketed loader shard collates its own batch,
padded to its own length; `Trainer.fit` assembles the ranks' batches into
one global batch of one padded shape (`parallel.dist.
host_local_batch_to_global`), so the two ranks follow one process trained
on the same global batches (the two shards' utterances collated together).

Held, with the tolerances of tests/test_torch_cli.py's two-rank test: the
ranks' padded lengths differ at some step (the case this test is for); the
logged step losses equal on both ranks and within 1e-4 relative of the one
process's; after 2 steps every BN statistic within 1e-5, Adam's first
moment of every parameter within 2e-3 of its leaf's largest entry plus
1e-7, and the norm of the parameters' difference within 1e-2 of the norm of
their change.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avec_tpu_torch.cli.functions import get_open_port

from test_torch_cli import ENV, _events, _rank_loaders

torch.set_num_threads(1)

TINY_LRS = '''
import torch

from avec_tpu_torch.configs import common, lrs23_ao
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       resolve_device)
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import Trainer

callback_path = "callbacks/tiny_lrs"


def build(callback_path=callback_path, device="cuda", data_parallel=False):
    device = resolve_device(device)
    model = AudioEfficientConformerInterCTC(
        vocab_size=256, att_type="patch", interctc_blocks=[],
        num_blocks=(1, 1, 1), device=device,
        generator=torch.Generator().manual_seed(0))
    model.set_regularization(False)
    trainer = Trainer(model=model, device=device, precision="float32",
                      loss=CTCLoss(zero_infinity=True, assert_shorter=False),
                      loss_weights=1.0, metrics=None,
                      data_parallel=data_parallel)
    training, evaluation = common.lrs_datasets(
        2, lrs23_ao.collate_fn(), dict(load_video=False),
        dict(load_video=False))
    return common.Setup(trainer, training, evaluation, callback_path,
                        "float32", 1, False, False)
'''

SIZES = {("LRS2", "pretrain"): 8, ("LRS2", "train"): 8, ("LRS2", "val"): 4,
         ("LRS2", "test"): 4, ("LRS3", "pretrain"): 8,
         ("LRS3", "trainval"): 8, ("LRS3", "test"): 4}


def test_two_gloo_ranks_on_ragged_utterances(tmp_path, monkeypatch):
    from avec_tpu_torch.data.lrs_fixture import write_lrs_fixture
    from avec_tpu_torch.decode.beam import import_config
    from avec_tpu_torch.train.checkpoint import load_checkpoint

    monkeypatch.chdir(tmp_path)
    write_lrs_fixture("datasets", seed=3, sizes=SIZES)
    cfg = tmp_path / "tiny_lrs.py"
    cfg.write_text(TINY_LRS)
    port = get_open_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "avec_tpu_torch.main", "-c", str(cfg), "-m",
         "training", "--cpu", "-d", "--coordinator", f"localhost:{port}",
         "--num_processes", "2", "--process_id", str(r), "--dist_log",
         "--steps_per_epoch", "2", "--epochs", "1", "--eval_steps", "1",
         "--step_log_period", "1"], cwd=tmp_path, env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    cb = tmp_path / "callbacks" / "tiny_lrs"
    losses = []
    for r in range(2):
        rows = _events(cb / "logs" / f"events_rank{r}.jsonl")
        losses.append([row["value"] for row in rows
                       if row["tag"] == f"Training-step-{r}/loss"])
    assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()
    assert losses[0] == losses[1]

    # one process on the same global batches: the two shards' utterances
    # collated together
    setup = import_config(str(cfg)).build(str(tmp_path / "ref"),
                                          device="cpu")
    ds = setup.training_dataset
    shards = [loader._batch_index_chunks()[:2]
              for loader in _rank_loaders(setup, monkeypatch)]
    trainer = setup.trainer
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    lengths = []
    for step, (a, b) in enumerate(zip(*shards)):
        parts = [ds.collate_fn([ds[int(i)] for i in idx]) for idx in (a, b)]
        lengths.append([p["inputs"][0].shape[1] for p in parts])
        batch = ds.collate_fn([ds[int(i)] for i in list(a) + list(b)])
        assert batch["inputs"][0].shape[1] == max(lengths[-1])
        got, _ = trainer.train_step(batch)
        assert losses[0][step] == pytest.approx(float(got["loss"]),
                                                rel=1e-4), step
    assert any(x != y for x, y in lengths), lengths
    ckpt = load_checkpoint(str(cb / "checkpoints_epoch_1_step_2.ckpt"))
    state, want = ckpt["model_state_dict"], trainer.model.state_dict()
    assert state.keys() == want.keys()
    params = dict(trainer.model.named_parameters())
    for k, w in want.items():
        if k not in params and w.is_floating_point():
            assert float((state[k] - w).abs().max()) <= 1e-5, k
    diff = sum(float(((state[k] - w) ** 2).sum()) for k, w in want.items()
               if k in params)
    change = sum(float(((w - init[k]) ** 2).sum()) for k, w in want.items()
                 if k in params)
    assert diff ** 0.5 <= 1e-2 * change ** 0.5, (diff, change)
    got_m = ckpt["optimizer_state_dict"]["state"]
    want_m = trainer.optimizer.optimizer.state_dict()["state"]
    for i, name in enumerate(params):
        g, w = got_m[i]["exp_avg"], want_m[i]["exp_avg"]
        err = float((g - w).abs().max())
        assert err <= 2e-3 * float(w.abs().max()) + 1e-7, (name, err)
    assert os.path.isdir(cb / "logs")
