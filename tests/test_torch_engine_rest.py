"""The rest of the port's engine vs the JAX package (avec_tpu/train/model.py,
checkpoint.py, utils/logging.py): a JAX msgpack checkpoint read by the
port (parameters, statistics, EMA, Adam moments and count, the step), the
step after it, `save_logits`' pickles, the JSON lines writer, and the fit's
logging, `eval_training`, `detect_anomaly`, `summary` and `generate`.

The model is a small audio-only one (vocab 16, blocks (1, 1, 1), regular
attention, InterCTC after block 1: outputs "ctc_0" and "outputs"), fp32 on
the CPU, weights drawn with numpy for the JAX variables' shapes; Dropout
and SpecAugment are the identity on the JAX side and off on the port's for
the module (the two packages draw from different streams). The JAX side
takes one Adam step (Noam(300, 360, 1.5), betas (0.9, 0.98), eps 1e-9, L2
1e-6, EMA 0.99) and saves its checkpoint with its own `save`.

Tolerances: the loaded state exact (the same float32 values, moved by the
layout rules); logits 1e-4; the step after the load as the engine tests
hold an anchored step (tests/test_torch_engine.py): losses 1e-4 relative,
every parameter within 2 lr + 1e-6; save_logits' logits 1e-4, lengths and
targets equal; the writer's records equal apart from "ts".
"""

import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.ops import audio as jaudio
from avec_tpu.ops import layers as jlayers
from avec_tpu.parallel import mesh as pmesh
from avec_tpu.train import losses as jlosses
from avec_tpu.train.optim import Adam as JaxAdam
from avec_tpu.train.schedulers import NoamDecayScheduler as JaxNoam
from avec_tpu.utils.logging import JsonlWriter as JaxJsonlWriter
from avec_tpu_torch.convert import params_from_jax, state_to_jax
from avec_tpu_torch.models.zoo import AudioEfficientConformerInterCTC
from avec_tpu_torch.train import checkpoint as tckpt
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.train.optim import Adam, Optimizer
from avec_tpu_torch.train.schedulers import NoamDecayScheduler
from avec_tpu_torch.utils.logging import JsonlWriter

from test_torch_support import random_variables, t

torch.set_num_threads(1)

AO = dict(vocab_size=16, att_type="regular", num_blocks=(1, 1, 1),
          interctc_blocks=(1,))
NAMES = ["ctc_0", "outputs"]
WEIGHTS = [0.5, 0.5]
NOAM = (300, 360, 1.5)
BETAS, EPS, WD, TAU = (0.9, 0.98), 1e-9, 1e-6, 0.99


def _batch(seed: int, lens=(16000, 11200)):
    """Noise up to the padded end (zero padding makes the stem's BN input
    bimodal, where the packages' fbanks differ; test_torch_train_step.py)."""
    rng = np.random.RandomState(seed)
    alen = np.asarray(lens, np.int32)
    audio = (rng.randn(len(alen), int(alen.max())) * 0.1).astype(np.float32)
    labels = rng.randint(1, 16, size=(len(alen), 5)).astype(np.int32)
    return {"inputs": [audio, alen],
            "targets": (labels, np.array([5, 3], np.int32))}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX model wired by hand (as tests/test_torch_engine.py does),
    one Adam step with EMA, its msgpack checkpoint, and its state after
    the step as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers.Dropout, "__call__",
                   lambda self, x, deterministic=True: x)
        mp.setattr(jaudio.SpecAugment, "__call__",
                   lambda self, x, lengths, rng, training=True: x)
        root = tmp_path_factory.mktemp("jax_ckpt")
        jmodel = jzoo.AudioEfficientConformerInterCTC(**AO)
        jmodel.compile(
            losses=jlosses.CTCLoss(zero_infinity=True, assert_shorter=False),
            loss_weights=WEIGHTS,
            optimizer=JaxAdam(lr=JaxNoam(*NOAM), betas=BETAS, eps=EPS,
                              weight_decay=WD))
        proto = {k: None for k in NAMES}
        jmodel.output_names = NAMES
        for name in ("losses", "loss_weights", "metrics", "decoders"):
            setattr(jmodel, name, jmodel.map_to_outputs(
                proto, getattr(jmodel, "compiled_" + name)))
        jmodel.mesh = pmesh.make_mesh(devices=jax.devices()[:1])
        args = _batch(0)["inputs"]
        shapes = jax.eval_shape(lambda: jmodel.net.init(
            {"params": jax.random.PRNGKey(0)}, *args, training=False))
        params, stats = random_variables(shapes, seed=0)
        jmodel.built = True
        jmodel.params = pmesh.replicate(jmodel.mesh, params)
        jmodel.batch_stats = pmesh.replicate(jmodel.mesh, stats)
        jmodel.opt_state = pmesh.replicate(jmodel.mesh,
                                           jmodel.optimizer.init(params))
        jmodel.set_ema(TAU)
        jmodel.ema_params = pmesh.replicate(jmodel.mesh, params)
        jmodel.ema_batch_stats = pmesh.replicate(jmodel.mesh, stats)
        jmodel.model_step = 0
        step_fn = jmodel._build_train_step(1, False)

        def jax_step(state, batch, n):
            stacked = pmesh.host_local_batch_to_global(
                jmodel.mesh, jmodel._stack_micro(batch, 1), batch_axis=1)
            rng = jax.random.fold_in(jmodel.train_rng, n)
            return step_fn(state, stacked, rng)

        new, _ = jax_step(jmodel._state(), _batch(1), 1)
        jmodel._load_state(new, step=1)
        path = str(root / "checkpoints_epoch_1_step_1.ckpt")
        jmodel.save(path)
        state = _np_tree(jmodel._state())
        yield dict(jmodel=jmodel, path=path, state=state, step=jax_step,
                   shapes=shapes, root=root)


def _trainer(optimizer=None) -> Trainer:
    model = AudioEfficientConformerInterCTC(device="cpu", **AO)
    trainer = Trainer(
        model=model, device="cpu", precision="float32",
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),
        loss_weights=WEIGHTS,
        optimizer=optimizer or Adam(lr=NoamDecayScheduler(*NOAM),
                                    betas=BETAS, eps=EPS, weight_decay=WD),
        metrics=None)
    trainer.model.set_regularization(False)
    return trainer


@pytest.fixture(scope="module")
def loaded(jax_side):
    trainer = _trainer()
    trainer.set_ema(TAU)
    trainer.load(jax_side["path"])
    return trainer


def test_jax_checkpoint_state_loads_exactly(jax_side, loaded):
    """Parameters, BN statistics, the EMA, Adam's moments and count and the
    step, each the JAX value under the layout rules, exactly."""
    state = jax_side["state"]
    assert tckpt.checkpoint_format(jax_side["path"]) == "jax"
    assert loaded.step == 1
    want = params_from_jax(state["params"], state["batch_stats"])
    got = loaded.model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ema = params_from_jax(state["ema_params"], state["ema_batch_stats"])
    for k, v in ema.items():
        assert torch.equal(loaded.ema_state[k], v), k
    adam = state["opt_state"][1]
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    opt = loaded.optimizer.optimizer
    named = dict(loaded.model.named_parameters())
    assert set(mu) == set(named) and len(opt.state) == len(named)
    for name, p in named.items():
        st = opt.state[p]
        assert float(st["step"]) == int(adam.count) == 1
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert bool(st["exp_avg_sq"].abs().sum() > 0) or "bias" in name


def test_jax_checkpoint_logits_match_the_jax_forward(jax_side, loaded):
    """The eval forward of the loaded model against the JAX forward of the
    saved state: every output's logits within 1e-4, lengths equal."""
    state = jax_side["state"]
    jmodel = jax_side["jmodel"]
    inputs = _batch(2)["inputs"]
    want = jax.jit(lambda p, s, *a: jmodel.apply_net(p, s, list(a), False)[0])(
        state["params"], state["batch_stats"], *inputs)
    loaded.model.eval()
    with torch.no_grad():
        got = loaded.model(*(t(a) for a in inputs))
    loaded.model.train()
    assert set(got) == set(want) == set(NAMES)
    for k in NAMES:
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k][0]),
                                   rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(got[k][1].numpy(),
                                      np.asarray(want[k][1]))


def test_step_after_jax_checkpoint_matches_the_jax_step(jax_side):
    """One Adam step of the port from the loaded checkpoint against the JAX
    step from the saved state on the same batch: losses within 1e-4
    relative, every parameter within 2 lr_2 + 1e-6 (the engine tests'
    anchored bound), the step counters 2."""
    trainer = _trainer()
    trainer.load(jax_side["path"])
    jmodel = jax_side["jmodel"]
    saved = jax_side["state"]
    state = dict(pmesh.replicate(jmodel.mesh, {
        k: saved[k] for k in ("params", "batch_stats", "opt_state",
                              "ema_params", "ema_batch_stats")}),
        step=jnp.asarray(1, jnp.int32))
    batch = _batch(3)
    new, (jl, _, _) = jax_side["step"](state, batch, 2)
    losses, infos = trainer.train_step(batch)
    assert trainer.step == int(new["step"]) == 2
    for k, v in jl.items():
        assert abs(float(losses[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    got, _ = state_to_jax({k: v.clone() for k, v in
                           trainer.model.state_dict().items()},
                          jax_side["shapes"]["params"],
                          jax_side["shapes"]["batch_stats"])
    bound = 2 * JaxNoam(*NOAM)(2) + 1e-6
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = dict(jax.tree_util.tree_flatten_with_path(_np_tree(new["params"]))[0])
    for path, leaf in g:
        assert np.abs(leaf - w[path]).max() <= bound, path


def test_optimizer_state_that_does_not_map_raises(jax_side):
    """A load that cannot carry the optimizer state raises and skips
    nothing: a moment missing from the JAX tree, an optax state with no
    Adam moments, a trainer whose optimizer is not Adam. The weights alone
    still load with load_optimizer=False."""
    raw = tckpt.read_msgpack(jax_side["path"])["optimizer_state_dict"]
    trainer = _trainer()
    adam = raw["1"]
    first = sorted(adam["mu"])[0]
    cut = {**raw, "1": {**adam, "mu": {k: v for k, v in adam["mu"].items()
                                       if k != first}}}
    with pytest.raises(ValueError, match="one to one"):
        trainer._load_optax_adam(cut)
    with pytest.raises(ValueError, match="0 Adam moment sets"):
        trainer._load_optax_adam({"0": {}, "1": {"trace": adam["mu"]}})
    sgd = _trainer(optimizer=lambda m: Optimizer(
        torch.optim.SGD(m.parameters(), lr=0.1), 0.1))
    with pytest.raises(ValueError, match="SGD"):
        sgd.load(jax_side["path"])
    sgd.load(jax_side["path"], load_optimizer=False)
    assert sgd.step == 0 and not sgd.optimizer.optimizer.state


def test_server_serves_a_jax_checkpoint(jax_side, loaded):
    """`Server(checkpoint=)` takes a JAX msgpack file as it takes a torch
    one: the weights are those `Trainer.load` reads."""
    from avec_tpu_torch.serve import Server

    srv = Server(mode="ao", device="cpu", precision="float32",
                 checkpoint=jax_side["path"], **AO)
    want = loaded.model.state_dict()
    for k, v in srv.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_missing_msgpack_raises_naming_it(jax_side, monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        tckpt.load_checkpoint(jax_side["path"])


def test_last_checkpoint_of_either_format(jax_side, tmp_path):
    """Both packages name checkpoints alike: `find_last_checkpoint` takes
    the largest step of either format, and the port loads each."""
    import shutil

    shutil.copy(jax_side["path"], tmp_path / "checkpoints_epoch_1_step_1"
                                             ".ckpt")
    trainer = _trainer()
    trainer.step = 3
    trainer.save(str(tmp_path / "checkpoints_epoch_2_step_3.ckpt"))
    assert tckpt.find_last_checkpoint(str(tmp_path)) == \
        "checkpoints_epoch_2_step_3.ckpt"
    assert tckpt.checkpoint_format(
        str(tmp_path / "checkpoints_epoch_2_step_3.ckpt")) == "torch"
    (tmp_path / "checkpoints_epoch_2_step_3.ckpt").unlink()
    assert tckpt.find_last_checkpoint(str(tmp_path)) == \
        "checkpoints_epoch_1_step_1.ckpt"


def test_save_logits_pickles_match_jax(jax_side, loaded, tmp_path):
    """logits.pkl and targets.pkl: per batch the outputs dict with its
    [logits, lengths] lists as numpy arrays, and the batch's targets."""
    state = jax_side["state"]
    jmodel = jax_side["jmodel"]
    batches = [_batch(4), _batch(5, lens=(8000, 12000))]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    saved = (jmodel.params, jmodel.batch_stats)
    jmodel.params, jmodel.batch_stats = (state["params"],
                                         state["batch_stats"])
    try:
        jmodel.save_logits(batches, str(jdir))
    finally:
        jmodel.params, jmodel.batch_stats = saved
    loaded.save_logits(batches, str(pdir))
    for name in ("logits.pkl", "targets.pkl"):
        with open(jdir / name, "rb") as f:
            want = pickle.load(f)
        with open(pdir / name, "rb") as f:
            got = pickle.load(f)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            if name == "targets.pkl":
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
                continue
            assert set(g) == set(w)
            for k in w:
                assert isinstance(g[k], list) and len(g[k]) == 2
                np.testing.assert_allclose(g[k][0], np.asarray(w[k][0]),
                                           rtol=0, atol=1e-4)
                np.testing.assert_array_equal(g[k][1], np.asarray(w[k][1]))


def test_jsonl_writer_records_match_jax(tmp_path):
    calls = [("add_scalar", ("Training-step/loss", 1.25, 3)),
             ("add_scalar", ("Evaluation-epoch/0/wer", np.float32(12.5), 1)),
             ("add_scalar", ("Training-epoch/loss", 0.5, None)),
             ("add_text", ("Exceptions", "Rank: 0\nboom", 7))]
    records = []
    for cls, name in ((JsonlWriter, "port"), (JaxJsonlWriter, "jax")):
        w = cls(str(tmp_path / f"{name}.jsonl"))
        for method, args in calls:
            getattr(w, method)(*args)
        w.close()
        with open(tmp_path / f"{name}.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert all("ts" in r for r in rows)
        records.append([{k: v for k, v in r.items() if k != "ts"}
                        for r in rows])
    assert records[0] == records[1] and len(records[0]) == 4


class _Batches:
    """A loader of fixed batches that records whether anomaly detection
    is on while the fit draws from it, and may fail at a batch."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at, self.anomaly = batches, fail_at, []

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            self.anomaly.append(torch.is_anomaly_enabled())
            if i == self.fail_at:
                raise RuntimeError("a broken batch")
            yield b


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fit_logs_the_jax_tags(tmp_path, monkeypatch):
    """fit with a callback path: step records at every log period (the
    step's losses, lr, grad_norm, step), epoch means and each evaluation
    set's losses under "Evaluation-epoch/{i}" (model.py:674-715, 746-755);
    detect_anomaly holds for the fit only; an exception is logged as text,
    then raised again (:613-624)."""
    monkeypatch.setenv("AVEC_TPU_LOG_FORMAT", "jsonl")
    trainer = _trainer()
    train = _Batches([_batch(6), _batch(7)])
    history = trainer.fit(train, epochs=1, dataset_eval=[[_batch(8)]],
                          callback_path=str(tmp_path), step_log_period=1,
                          saving_period_epoch=None, detect_anomaly=True,
                          log_figure_period_step=5, grad_init_scale=1024.0)
    assert train.anomaly == [True, True] and not torch.is_anomaly_enabled()
    tags = {r["tag"] for r in _records(tmp_path / "logs" / "events.jsonl")}
    losses = {"loss", "loss_ctc_0", "loss_outputs"}
    want = ({f"Training-step/{k}" for k in losses | {"lr", "grad_norm",
                                                     "step"}}
            | {f"Training-epoch/{k}" for k in losses}
            | {f"Evaluation-epoch/0/{k}" for k in losses})
    assert tags == want
    steps = [r for r in _records(tmp_path / "logs" / "events.jsonl")
             if r["tag"] == "Training-step/step"]
    assert [r["step"] for r in steps] == [1, 2]
    assert history[0]["steps"] == 2 and history[0]["metrics"] == {}

    bad = _Batches([_batch(6), _batch(7)], fail_at=1)
    with pytest.raises(RuntimeError, match="a broken batch"):
        trainer.fit(bad, epochs=1, callback_path=str(tmp_path),
                    saving_period_epoch=None)
    rows = [r for r in _records(tmp_path / "logs" / "events.jsonl")
            if r["tag"] == "Exceptions"]
    assert rows and "a broken batch" in rows[-1]["text"]
    assert rows[-1]["text"].startswith("Rank: 0")


def test_eval_training_gives_a_classifier_its_accuracy(tmp_path,
                                                       monkeypatch):
    """A classifier's training outputs take its device metrics
    (model.py:473-475) under the names its evaluation gives them; a CTC
    model has none."""
    from avec_tpu_torch.configs import lm_tone

    monkeypatch.setenv("AVEC_TPU_LOG_FORMAT", "jsonl")
    setup = lm_tone.build(str(tmp_path / "lm"), device="cpu",
                          corpus_samples=32)
    batch = next(iter(setup.train_loader))
    setup.trainer.eval_training = True
    _, infos = setup.trainer.train_step(batch)
    setup.trainer.eval_training = False
    _, metrics = setup.trainer.evaluate([batch])
    assert set(infos["metrics"]) == set(metrics) and metrics
    assert all(0.0 <= float(v) <= 100.0 for v in infos["metrics"].values())
    history = setup.trainer.fit(setup.train_loader, epochs=1,
                                steps_per_epoch=2, callback_path=str(
                                    tmp_path / "lm"), step_log_period=1,
                                saving_period_epoch=None)
    assert set(history[0]["metrics"]) == set(metrics)
    tags = {r["tag"] for r in _records(tmp_path / "lm" / "logs" /
                                       "events.jsonl")}
    assert {f"Training-step/{k}" for k in metrics} <= tags


def test_summary_show_dict_and_generate(capsys):
    trainer = _trainer()
    trainer.summary(show_dict=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Model name: Audio Efficient Conformer Inter CTC"
    n = sum(p.numel() for p in trainer.model.parameters())
    assert out[1] == f"Number Parameters: {n:,}" and trainer.num_params() == n
    assert len(out) == 2 + len(trainer.model.state_dict())
    with pytest.raises(NotImplementedError, match="forward_generate"):
        trainer.generate([_batch(0)])
