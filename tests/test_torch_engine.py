"""The port's training engine vs the JAX package's (avec_tpu/train/model.py):
the accumulated step, EMA, evaluate, checkpoints in both directions, SWA and
the fit loop's checkpoints, at the AV-Tone depth and widths (configs/
Synthetic/AV-Tone.py: vocab 32, v (2, 1), a (2, 2, 1), f 2, its loss
weights, Adam + Noam(300, 360, 1.5), WER on "outputs") on tone utterances of
2-3 tokens (7200 samples, 12 video frames), fp32 on the CPU.

The JAX side is set by hand, as `test_torch_train_step.py`'s `av` fixture
does: seeded variables from `eval_shape`, the loss, metric and decoder
wiring through `map_to_outputs`, a one-device mesh, and the step and eval
functions from `_build_train_step` / `evaluate`, without a `build`. Dropout
and SpecAugment are off on both sides for the whole module (the two packages
draw from different random streams): the JAX layers are replaced by the
identity here, the port's through `set_regularization(False)`. The batches
are collated without length bucketing, so the audio carries noise up to its
padded end (zero-padded audio makes the audio stem's BN input bimodal, where
the two packages' fbanks differ by 4e-4; see test_torch_train_step.py).

Tolerances: losses 1e-4 relative; BN statistics 1e-5; parameters after N
Adam steps within 2 * sum(lr_t, t = 1..N) + 1e-6 (Adam's early updates are
about lr * sign(g) per entry, so a gradient entry whose sign rounding flips
moves a parameter by up to 2 lr; the trunk's fp32 gradients differ by up to
9e-2 of a leaf's largest entry, test_torch_train_step.py), a bound that
holds the step, not the optimizer: the optimizer is held by the JAX
package's Adam on the port's own gradients, its moments and parameters
within 1e-5 of the size of the terms they sum (`_adam_on_port_gradients`);
logits 2e-3 with identical greedy ids; averaged SWA
parameters 1e-7.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.data.collate import CollateFn as JaxCollateFn
from avec_tpu.data.loader import DataLoader as JaxLoader
from avec_tpu.data.synthetic import ToneAVSpeechDataset as JaxTone
from avec_tpu.decode.greedy import CTCGreedySearchDecoder as JaxGreedy
from avec_tpu.models import zoo as jzoo
from avec_tpu.ops import audio as jaudio
from avec_tpu.ops import layers as jlayers
from avec_tpu.parallel import mesh as pmesh
from avec_tpu.train import checkpoint as jckpt
from avec_tpu.train import losses as jlosses
from avec_tpu.train.metrics import WordErrorRate as JaxWER
from avec_tpu.train.optim import Adam as JaxAdam
from avec_tpu.train.schedulers import NoamDecayScheduler as JaxNoam
from avec_tpu.train.torch_convert import convert_state_dict
from avec_tpu_torch.configs import av_tone
from avec_tpu_torch.convert import (grads_to_jax_layout, params_from_jax,
                                    state_to_jax)
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.data.synthetic import ToneAVSpeechDataset, tone_tokenizer
from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
from avec_tpu_torch.train import checkpoint as tckpt
from avec_tpu_torch.train.losses import CTCLoss
from avec_tpu_torch.train.metrics import WordErrorRate
from avec_tpu_torch.train.model import Trainer

from test_torch_serve import AV_TONE
from test_torch_support import random_variables

torch.set_num_threads(1)

OUTPUTS = ["outputs", "f_ctc_0", "v_ctc_1", "a_ctc_1", "a_ctc_3"]
MAX_TOKENS = 3
ACCUM = 2
NOAM = (300, 360, 1.5)                   # AV-Tone.py:80-81
BETAS, WD = (0.9, 0.98), 1e-6            # AV-Tone.py:79-82
FLOOR = 1e-6
SPECS = dict(inputs_params=[{"axis": 0, "padding": True}, {"axis": 3},
                            {"axis": 1, "padding": True}, {"axis": 4}],
             targets_params=({"axis": 2, "padding": True}, {"axis": 5}))


def _sets(jax_side: bool, n: int, seed: int, shuffle: bool):
    collate = (JaxCollateFn if jax_side else CollateFn)(
        bucket_granularity=0, **{k: type(v)(dict(p) for p in v)
                                  for k, v in SPECS.items()})
    cls = JaxTone if jax_side else ToneAVSpeechDataset
    return cls(num_samples=n, vocab_size=32, max_len=MAX_TOKENS, seed=seed,
               batch_size=2, collate_fn=collate, shuffle=shuffle)


def _loaders(jax_side: bool):
    """(training loader: 8 utterances, 2 x 2 per batch; evaluation loader:
    32 utterances, 8 per batch, in order)."""
    cls = JaxLoader if jax_side else DataLoader
    train = cls(_sets(jax_side, 8, 0, True), batch_size=2, accum=ACCUM,
                drop_last=True)
    evals = cls(_sets(jax_side, 32, 10_000_000, False), batch_size=8)
    return train, evals


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _pairs(got, want):
    """(name, got leaf, want leaf) by name over two trees of one structure
    (the JAX state's dicts keep module order, the converted ones sorted
    order)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in sorted(w):
        assert g[k].shape == w[k].shape, k
        yield k, g[k], w[k]


def _lr_sum(n_steps: int) -> float:
    return sum(JaxNoam(*NOAM)(t) for t in range(1, n_steps + 1))


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """Checkpoints of this model are 146-585 MB: none outlives its test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The JAX model wired by hand and the variables, the tokenizer, both
    packages' loaders, with the JAX package's Dropout and SpecAugment the
    identity for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers.Dropout, "__call__",
                   lambda self, x, deterministic=True: x)
        mp.setattr(jaudio.SpecAugment, "__call__",
                   lambda self, x, lengths, rng, training=True: x)
        root = tmp_path_factory.mktemp("engine")
        tok = str(root / "tokenizer.json")
        tone_tokenizer(32).save(tok)
        jmodel = jzoo.AudioVisualEfficientConformerInterCTC(use_flash=False,
                                                            **AV_TONE)
        jmodel.compile(
            losses=jlosses.CTCLoss(zero_infinity=True, assert_shorter=False),
            loss_weights=av_tone.LOSS_WEIGHTS,
            optimizer=JaxAdam(lr=JaxNoam(*NOAM), betas=BETAS,
                              eps=1e-9, weight_decay=WD),
            metrics={"outputs": JaxWER()},
            decoders={"outputs": JaxGreedy(tokenizer_path=tok)})
        proto = {k: None for k in OUTPUTS}
        jmodel.output_names = OUTPUTS
        for name in ("losses", "loss_weights", "metrics", "decoders"):
            setattr(jmodel, name, jmodel.map_to_outputs(
                proto, getattr(jmodel, "compiled_" + name)))
        jmodel.mesh = pmesh.make_mesh(devices=jax.devices()[:1])
        train_j, eval_j = _loaders(True)
        args = next(iter(train_j))["inputs"]
        shapes = jax.eval_shape(lambda: jmodel.net.init(
            {"params": jax.random.PRNGKey(0)}, *args, training=False))
        params, stats = random_variables(shapes, seed=0)
        # a head that spreads the greedy ids over the vocabulary (with the
        # drawn bias every frame of every utterance takes one token)
        head = params["encoder"]["head"]
        head["bias"] = np.zeros_like(head["bias"])
        head["kernel"] = head["kernel"] * np.float32(8.0)
        jmodel.built = True
        env = dict(jmodel=jmodel, params=params, stats=stats, tok=tok,
                   root=root, train_j=train_j, eval_j=eval_j)
        _reset_jax(env)
        yield env
        shutil.rmtree(root, ignore_errors=True)


def _reset_jax(env):
    """Fresh JAX state arrays from the seeded variables at step 0 (the JAX
    train step donates the arrays it is given)."""
    jmodel = env["jmodel"]
    jmodel.params = pmesh.replicate(jmodel.mesh, env["params"])
    jmodel.batch_stats = pmesh.replicate(jmodel.mesh, env["stats"])
    jmodel.opt_state = pmesh.replicate(
        jmodel.mesh, jmodel.optimizer.init(env["params"]))
    jmodel.ema_params = jmodel.ema_batch_stats = None
    jmodel.model_step = 0


def _trainer(env, params=None, stats=None) -> Trainer:
    model = AudioVisualEfficientConformerInterCTC(device="cpu", **AV_TONE)
    model.load_state_dict(params_from_jax(
        env["params"] if params is None else params,
        env["stats"] if stats is None else stats), strict=True)
    trainer = Trainer(
        model=model, device="cpu", precision="float32",
        loss=CTCLoss(zero_infinity=True, assert_shorter=False),
        loss_weights=av_tone.LOSS_WEIGHTS, optimizer=av_tone.optimizer(),
        metrics={"outputs": WordErrorRate()},
        decoders={"outputs": CTCGreedySearchDecoder(
            tokenizer_path=env["tok"])})
    trainer.model.set_regularization(False)
    return trainer


def _jax_state_of(env, trainer):
    """The port trainer's state (parameters, BN statistics, Adam moments and
    count, step) as a JAX train-step state."""
    jmodel = env["jmodel"]
    sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    params, stats = state_to_jax(sd, env["params"], env["stats"])
    opt = jmodel.optimizer.init(params)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    # copies: a JAX array on the CPU may share a numpy array's memory, and
    # the port's next step updates its moments in place
    moments = {names[id(p)]: {k: v.clone() for k, v in st.items()}
               for p, st in trainer.optimizer.optimizer.state.items()}
    if moments:
        mu, nu = ({n: m[key] for n, m in moments.items()}
                  for key in ("exp_avg", "exp_avg_sq"))
        count = {int(m["step"]) for m in moments.values()}
        assert count == {trainer.step}
        opt = (opt[0], opt[1]._replace(
            count=jnp.asarray(trainer.step, jnp.int32),
            mu=grads_to_jax_layout(mu, env["params"]),
            nu=grads_to_jax_layout(nu, env["params"])))
    state = pmesh.replicate(jmodel.mesh, {
        "params": params, "batch_stats": stats, "opt_state": opt})
    return dict(state, step=jnp.asarray(trainer.step, jnp.int32),
                ema_params=None, ema_batch_stats=None)


def _adam_on_port_gradients(env, trainer, before):
    """The JAX package's Adam (its optax chain under Noam, the AV-Tone
    arguments) applied to the gradients the port's step just used, from the
    port's state before that step (`before`, as `_jax_state_of` gives it),
    against the port's state after the step. Per leaf, the worst entry of
    |port - JAX| / tolerance for Adam's first and second moments and the
    new parameters, and whether every entry of the leaf stayed put.

    The tolerances are 1e-5 of the size of the terms that each quantity
    sums, since its rounding follows them: b1 |mu| + (1 - b1) |g'| for mu
    and b2 nu + (1 - b2) |g'|^2 for nu, with the moments before the step and
    |g'| = |g| + wd |p| (where the decay cancels the gradient, or a new
    gradient its moment, the result is a difference); for the update
    lr_t / (1 - b1^t) times mu's scale over sqrt(nu / (1 - b2^t)) + eps,
    plus one ulp of the new parameter for its own rounding."""
    jmodel = env["jmodel"]
    grads = grads_to_jax_layout(
        {n: p.grad.detach().clone()
         for n, p in trainer.model.named_parameters()}, env["params"])
    after = _jax_state_of(env, trainer)
    updates, opt = jmodel.optimizer.update(
        grads, before["opt_state"], before["params"], trainer.step - 1)
    want = jax.tree.map(jnp.add, before["params"], updates)
    out = {"params": {}, "mu": {}, "nu": {}, "unmoved": []}
    terms = {k: np.abs(g) + WD * np.abs(p) for (k, g, p) in
             _pairs(grads, before["params"])}
    tiny = np.finfo(np.float32).tiny
    scales = {}
    for key, beta, power in (("mu", BETAS[0], 1), ("nu", BETAS[1], 2)):
        old = dict(_leaves(getattr(before["opt_state"][1], key)))
        for k, g, w in _pairs(getattr(after["opt_state"][1], key),
                              getattr(opt[1], key)):
            scale = beta * np.abs(old[k]) + (1 - beta) * terms[k] ** power
            scales[key, k] = (scale, w)
            out[key][k] = float((np.abs(g - w) / np.maximum(
                1e-5 * scale, tiny)).max())
    t = trainer.step
    lr = JaxNoam(*NOAM)(t)
    for (k, g, w), (_, p0, _) in zip(_pairs(after["params"], want),
                                     _pairs(before["params"], want)):
        mu_scale, nu = scales["mu", k][0], scales["nu", k][1]
        u_scale = (lr / (1 - BETAS[0] ** t) * mu_scale
                   / (np.sqrt(nu / (1 - BETAS[1] ** t)) + 1e-9))
        tol = 1e-5 * u_scale + np.spacing(np.abs(w))
        out["params"][k] = float((np.abs(g - w) / tol).max())
        if np.array_equal(g, p0):
            out["unmoved"].append(k)
    return out


def _np(state):
    return (jax.tree.map(np.asarray, state["params"]),
            jax.tree.map(np.asarray, state["batch_stats"]))


@pytest.fixture(scope="module")
def trained(env):
    """Two accumulated steps (A = 2 micro-batches of 2) of the port on two
    batches, beside the JAX step on the same batches twice: from the port's
    state before each step ("anchored": the port's parameters, statistics
    and Adam moments carried over), and on its own from the same variables
    ("free"); and the JAX package's Adam on the gradients of each port step
    ("adam", `_adam_on_port_gradients`)."""
    jmodel = env["jmodel"]
    step_fn = jmodel._build_train_step(ACCUM, False)
    jmodel._train_step_cache[(ACCUM, False, 0.0, None)] = step_fn
    trainer = _trainer(env)
    train_t, _ = _loaders(False)
    _reset_jax(env)
    free = jmodel._state()
    records = []
    for n, (bt, bj) in enumerate(zip(train_t, env["train_j"]), 1):
        stacked = pmesh.host_local_batch_to_global(
            jmodel.mesh, jmodel._stack_micro(bj, ACCUM), batch_axis=1)
        rng = jax.random.fold_in(jmodel.train_rng, n)
        before = _jax_state_of(env, trainer)
        losses, infos = trainer.train_step(bt, accumulated_steps=ACCUM)
        adam = _adam_on_port_gradients(env, trainer, before)
        anchored = before if n > 1 else None
        free, (jl, _, jinfo) = step_fn(free, stacked, rng)
        rec = dict(losses={k: float(v) for k, v in losses.items()},
                   lr=infos["lr"], jax_lr=float(jinfo["lr"]), adam=adam,
                   port=state_to_jax({k: v.clone() for k, v in
                                      trainer.model.state_dict().items()},
                                     env["params"], env["stats"]),
                   free=_np(free))
        if anchored is not None:
            anchored, (jl, _, _) = step_fn(anchored, stacked, rng)
        rec.update(jax_losses={k: float(v) for k, v in jl.items()},
                   anchored=_np(free if anchored is None else anchored))
        records.append(rec)
    return dict(trainer=trainer, records=records, jax_state=free)


def test_accumulated_train_steps_match_jax(env, trained):
    """Two steps of accumulated_steps=2. Each step against the JAX step from
    the same state: the six losses within 1e-4, the BN statistics after it
    (both micro-batches' updates, in order) within 1e-5, the parameters
    within 2 lr + 1e-6. The port's run against the JAX run from the same
    variables: the parameters within 2 * sum(lr) + 1e-6 after each step.
    (The anchored comparison keeps the BN check at 1e-5 past the first
    step: the trunk's parameters of the two runs part by up to 2 lr where a
    gradient sign differs, and its statistics then by 1.7e-5.)"""
    records = trained["records"]
    assert len(records) == 2 and trained["trainer"].step == 2
    for n, rec in enumerate(records, 1):
        assert set(rec["losses"]) == set(rec["jax_losses"]) == {"loss"} | {
            "loss_" + k for k in OUTPUTS}
        for k, want in rec["jax_losses"].items():
            assert rec["losses"][k] == pytest.approx(want, rel=1e-4), (n, k)
        assert rec["lr"] == pytest.approx(rec["jax_lr"], rel=1e-6)
        (gp, gs), (ap, as_), (fp, _) = rec["port"], rec["anchored"], \
            rec["free"]
        for k, g, w in _pairs(gs, as_):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"step {n} {k}")
        lr = JaxNoam(*NOAM)(n)
        worst = max(float(np.abs(g - w).max()) for _, g, w in _pairs(gp, ap))
        assert worst <= 2 * lr + FLOOR, (n, worst)
        worst = max(float(np.abs(g - w).max()) for _, g, w in _pairs(gp, fp))
        assert worst <= 2 * _lr_sum(n) + FLOOR, (n, worst)
        moved = max(float(np.abs(g - p0).max())
                    for _, g, p0 in _pairs(gp, env["params"]))
        assert moved > 0.5 * JaxNoam(*NOAM)(1), (n, moved)


def test_adam_step_matches_jax_on_the_same_gradients(trained):
    """The optimizer alone: each step's gradients, as the port used them,
    through the JAX package's Adam (betas (0.9, 0.98), eps 1e-9, L2 1e-6 in
    the gradient, Noam(300, 360, 1.5)) from the port's state before the
    step. Entry by entry, Adam's moments and the port's new parameters
    within 1e-5 of the size of the terms they sum (the update's plus one
    ulp of the parameter); every leaf moved. (A flipped or missing update
    is off by lr, 1.5e-5 at the first step, against a tolerance of about
    1.5e-10 plus an ulp.)"""
    for n, rec in enumerate(trained["records"], 1):
        adam = rec["adam"]
        assert not adam["unmoved"], (n, adam["unmoved"])
        for key in ("params", "mu", "nu"):
            worst = max(adam[key].items(), key=lambda kv: kv[1])
            assert worst[1] <= 1.0, (n, key, worst)


def test_accumulation_splits_the_batch_in_order(env):
    """accumulated_steps=2 on a batch of 4 gives the gradients of the two
    halves, each a batch of its own, summed and halved."""
    batch = next(iter(_loaders(False)[0]))
    halves = [{k: type(v)(a[i * 2:(i + 1) * 2] for a in v)
               for k, v in batch.items()} for i in range(2)]
    trainer = _trainer(env)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    whole = trainer._forward_backward(batch, accumulated_steps=2)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    stats = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(state)
    parts = [trainer.loss_and_grads(h) for h in halves]
    for k, v in whole.items():
        assert float(v) == pytest.approx(
            float(parts[0][0][k] + parts[1][0][k]) / 2, rel=1e-6)
    for n, g in grads.items():
        want = (parts[0][1][n] + parts[1][1][n]) / 2
        assert float((g - want).abs().max()) <= 1e-6 * max(
            float(want.abs().max()), 1.0), n
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, stats[k]), k     # the two halves, in order
    with pytest.raises(ValueError, match="micro-batches"):
        trainer.train_step(batch, accumulated_steps=3)


def test_ema_follows_the_formula_and_copies_buffers(env):
    trainer = _trainer(env)
    trainer.set_ema(0.9)
    train, evals = _loaders(False)
    for batch in train:
        before = {k: v.clone() for k, v in trainer.ema_state.items()}
        trainer.train_step(batch)
        live = trainer.model.state_dict()
        params = dict(trainer.model.named_parameters())
        for k, e in trainer.ema_state.items():
            if k in params:
                want = 0.9 * before[k] + 0.1 * live[k]
                assert float((e - want).abs().max()) <= 1e-6, k
            else:
                assert torch.equal(e, live[k]), k
    assert any(not torch.equal(trainer.ema_state[k], v)
               for k, v in trainer.model.state_dict().items())
    # evaluate(use_ema=True) runs the model on the EMA state
    got = trainer.evaluate(evals, eval_steps=1, use_ema=True)
    other = _trainer(env)
    other.model.load_state_dict(trainer.ema_state)
    want = other.evaluate(evals, eval_steps=1)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == want[1]


def test_evaluate_matches_jax(env):
    """Eval-mode losses within 1e-4 and the greedy transcripts of the 32
    utterances identical to JAX evaluate(return_transcripts=True); the WER
    the same over the transcripts and per batch."""
    jmodel = env["jmodel"]
    _reset_jax(env)
    trainer = _trainer(env)
    _, evals = _loaders(False)
    got = trainer.evaluate(evals, recompute_metrics=True,
                           return_transcripts=True)
    want = jmodel.evaluate(env["eval_j"], recompute_metrics=True,
                           return_transcripts=True)
    for k, w in want[0].items():
        assert got[0][k] == pytest.approx(w, rel=1e-4), k
    assert set(got[0]) == set(want[0])
    truths, preds = got[2]["wer"]
    assert (truths, preds) == tuple(want[2]["wer"])
    assert len(preds) == 32 and len(set(preds)) > 1
    assert got[1]["wer"] == pytest.approx(want[1]["wer"], abs=1e-9)
    per_batch = trainer.evaluate(evals)
    assert per_batch[1]["wer"] == pytest.approx(
        np.mean([WordErrorRate()(truths[i:i + 8], preds[i:i + 8])
                 for i in range(0, 32, 8)]), abs=1e-9)


def _jax_logits(jmodel, params, stats, batch):
    out = jax.jit(lambda p, s, x: jmodel.apply_net(p, s, x, False)[0][
        "outputs"])(params, stats, batch["inputs"])
    return np.asarray(out[0]), np.asarray(out[1])


def _port_logits(trainer, batch):
    trainer.model.eval()
    with torch.no_grad():
        inputs, _ = trainer._to_device(batch)
        logits, lens = trainer.model(*inputs)["outputs"]
    trainer.model.train()
    return logits.numpy(), lens.numpy()


def _greedy_ids(logits, lens):
    ids = logits.argmax(-1)
    out = []
    for row, n in zip(ids, lens):
        seq = [int(t) for i, t in enumerate(row[:n])
               if t != 0 and (i == 0 or t != row[i - 1])]
        out.append(seq)
    return out


def test_port_checkpoint_loads_in_jax(env, trained, tmp_path):
    """The port's checkpoint after two steps (with its optimizer and an
    EMA) read by the JAX package's own `Model.load` (a torch file, converted
    by name): the JAX variables equal the port's exactly, the step is
    restored, and the JAX logits agree with the port's within 2e-3 with
    identical greedy ids."""
    jmodel, trainer = env["jmodel"], trained["trainer"]
    trainer.set_ema(0.5)
    path = str(tmp_path / "checkpoints_epoch_1_step_2.ckpt")
    trainer.save(path)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    payload = torch.load(path, weights_only=True)
    assert payload["model_step"] == 2 and not payload["is_distributed"]
    assert payload["optimizer_state_dict"]["state"]
    _reset_jax(env)
    try:
        jmodel.ema_params = jmodel.params
        jmodel.ema_batch_stats = jmodel.batch_stats
        jmodel.load(path)
        assert jmodel.model_step == 2
        want_p, want_s = state_to_jax(trainer.model.state_dict(),
                                      env["params"], env["stats"])
        for tree, want in ((jmodel.params, want_p),
                           (jmodel.batch_stats, want_s),
                           (jmodel.ema_params, want_p)):
            for k, g, w in _pairs(jax.tree.map(np.asarray, tree), want):
                assert np.array_equal(g, w), k
        batch = next(iter(_loaders(False)[1]))
        logits, lens = _port_logits(trainer, batch)
        jlogits, jlens = _jax_logits(jmodel, jmodel.params,
                                     jmodel.batch_stats, batch)
    finally:
        _reset_jax(env)
        trainer.set_ema(0.0)
    assert np.array_equal(lens, jlens)
    assert np.abs(logits - jlogits).max() <= 2e-3
    assert _greedy_ids(logits, lens) == _greedy_ids(jlogits, jlens)


def test_jax_state_in_torch_format_loads_in_the_port(env, trained, tmp_path):
    """The JAX state after its two steps, written as a torch checkpoint in
    the reference's format (the port's `params_from_jax` names; the JAX
    package's `convert_state_dict` maps the file back to the JAX variables
    exactly), with an EMA and a step: the port's `load` restores the
    variables exactly, the EMA and the step, and the port's logits agree
    with the JAX logits within 2e-3 with identical greedy ids."""
    jmodel = env["jmodel"]
    jstate = trained["jax_state"]
    jp = jax.tree.map(np.asarray, jstate["params"])
    js = jax.tree.map(np.asarray, jstate["batch_stats"])
    sd = params_from_jax(jp, js)
    template = jckpt.state_dict_flatten({"params": jp, "batch_stats": js})
    back, report = convert_state_dict(sd, template)
    assert not report["unexpected"]
    for k, v in template.items():
        assert np.array_equal(back[k], v), k
    path = str(tmp_path / "jax_state.ckpt")
    ema = params_from_jax(env["params"], env["stats"])
    torch.save({"model_state_dict": {"module." + k: v for k, v in sd.items()},
                "optimizer_state_dict": None, "model_step": 7,
                "is_distributed": False, "ema_model_state_dict": ema}, path)
    trainer = _trainer(env)
    trainer.set_ema(0.9)
    trainer.load(path, load_optimizer=False)
    assert trainer.step == 0                       # restored with the optimizer
    assert tckpt.load_checkpoint(path)["model_step"] == 7
    got_p, got_s = state_to_jax(trainer.model.state_dict(), jp, js)
    for k, g, w in _pairs({"p": got_p, "s": got_s}, {"p": jp, "s": js}):
        assert np.array_equal(g, w), k
    for k, v in ema.items():
        assert torch.equal(trainer.ema_state[k], v), k
    batch = next(iter(_loaders(False)[1]))
    logits, lens = _port_logits(trainer, batch)
    jlogits, jlens = _jax_logits(jmodel, jp, js, batch)
    assert np.array_equal(lens, jlens)
    assert np.abs(logits - jlogits).max() <= 2e-3
    assert _greedy_ids(logits, lens) == _greedy_ids(jlogits, jlens)


@pytest.fixture(scope="module")
def epoch_checkpoints(env, tmp_path_factory):
    """Two end-of-epoch checkpoints of the port (the states after its
    second and third step) and an earlier one of epoch 1 that SWA must
    skip, without the optimizer state (a file is 146 MB)."""
    d = tmp_path_factory.mktemp("swa")
    trainer = _trainer(env)
    train, _ = _loaders(False)
    batches = list(train)
    for i, name in enumerate(("epoch_1_step_1", "epoch_1_step_2",
                              "epoch_2_step_3")):
        trainer.train_step(batches[i % 2], accumulated_steps=ACCUM)
        trainer.save(str(d / f"checkpoints_{name}.ckpt"),
                     save_optimizer=False)
    yield d
    shutil.rmtree(d)


@pytest.mark.parametrize("swa_type", ["equal", "exp"])
def test_swa_matches_jax(env, epoch_checkpoints, swa_type):
    """SWA over epochs 1-2 (their largest-step checkpoints): the averaged
    parameters within 1e-7 of the JAX package's `swa` over the same files,
    and the BN statistics re-estimated over two batches within 1e-5; the
    SWA checkpoint reloads to the same state."""
    jmodel, d = env["jmodel"], epoch_checkpoints
    name = f"checkpoints_swa-{swa_type}-1-2.ckpt"
    trainer = _trainer(env)
    path = trainer.swa(_loaders(False)[1], str(d), start_epoch=1,
                       end_epoch=2, update_steps=2, swa_type=swa_type)
    assert path == str(d / name)
    reloaded = _trainer(env)
    reloaded.load(path)
    os.remove(path)
    for k, v in reloaded.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    _reset_jax(env)
    try:
        jmodel.swa(env["eval_j"], str(d), start_epoch=1, end_epoch=2,
                   update_steps=2, swa_type=swa_type)
        want_p = jax.tree.map(np.asarray, jmodel.params)
        want_s = jax.tree.map(np.asarray, jmodel.batch_stats)
    finally:
        _reset_jax(env)
        if os.path.exists(path):
            os.remove(path)
    got_p, got_s = state_to_jax(trainer.model.state_dict(), want_p, want_s)
    for k, g, w in _pairs(got_p, want_p):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=k)
    last = tckpt.load_checkpoint(str(d / "checkpoints_epoch_2_step_3.ckpt"))
    old = dict(_leaves(state_to_jax(last["model_state_dict"], want_p,
                                    want_s)[1]))
    moved = 0
    for k, g, w in _pairs(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
        moved += int(np.abs(g - old[k]).max() > 1e-6)
    assert moved == len(old)


def test_fit_checkpoints_match_jax(env, tmp_path, monkeypatch):
    """fit for 2 epochs of 2 accumulated steps, a checkpoint per epoch: the
    JAX fit's file names (checkpoints_epoch_{epoch + 1}_step_{step}.ckpt,
    avec_tpu/train/model.py:694-696, :720-722) beside its logs/ directory
    (:1087-1101; JSON lines here), model_step, the JAX package's
    `find_last_checkpoint` on the port's files, and a resume from the
    first. The loop is `set_epoch` then `train_step` per batch: its state
    is bit-identical to those calls made by hand."""
    monkeypatch.setenv("AVEC_TPU_LOG_FORMAT", "jsonl")
    port_dir = tmp_path / "port"
    trainer = _trainer(env)
    train_t, _ = _loaders(False)
    epochs_seen = []
    set_epoch = train_t.set_epoch
    train_t.set_epoch = lambda e: (epochs_seen.append(e), set_epoch(e))
    history = trainer.fit(train_t, epochs=2, callback_path=str(port_dir),
                          accumulated_steps=ACCUM, steps_per_epoch=2,
                          step_log_period=1)
    assert epochs_seen == [0, 1]
    assert [h["steps"] for h in history] == [2, 2]
    names = sorted(os.listdir(port_dir))
    want = [f"checkpoints_epoch_{e}_step_{2 * e}.ckpt" for e in (1, 2)]
    assert names == want + ["logs"] and trainer.step == 4
    assert os.listdir(port_dir / "logs") == ["events.jsonl"]
    assert tckpt.find_last_checkpoint(str(port_dir)) == \
        jckpt.find_last_checkpoint(str(port_dir)) == want[-1]
    assert tckpt.find_last_checkpoint(str(port_dir), True) == \
        str(port_dir / want[-1])
    first = tckpt.load_checkpoint(str(port_dir / want[0]))
    assert first["model_step"] == 2 and first["optimizer_state_dict"]
    resumed = _trainer(env)
    resumed.load(str(port_dir / want[0]))
    assert resumed.step == 2
    by_hand = _trainer(env)
    sums = []
    for epoch in range(2):
        train_t.set_epoch(epoch)
        losses = [by_hand.train_step(b, accumulated_steps=ACCUM)[0]
                  for b in train_t]
        sums.append({k: sum(float(x[k]) for x in losses) / 2
                     for k in losses[0]})
    for k, v in by_hand.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    for h, want_losses in zip(history, sums):
        assert h["losses"] == pytest.approx(want_losses, rel=1e-6)


def test_per_output_specs_match_jax_map_to_outputs():
    """Metric and decoder specs conform to the output names as the JAX
    `map_to_outputs` does (a dict by name, a list in order, one object for
    all; an unknown name raises); the port leaves out the None entries."""
    from avec_tpu.train.model import Model as JaxModel
    from avec_tpu_torch.train.model import _per_output

    a, b = object(), object()
    proto = {k: None for k in OUTPUTS}
    for struct in ({"outputs": a, "a_ctc_1": b}, [a, None, b], [a], a, None):
        want = JaxModel().map_to_outputs(proto, struct) or {}
        assert _per_output(struct, OUTPUTS) == {
            k: v for k, v in want.items() if v is not None}
    with pytest.raises(KeyError):
        JaxModel().map_to_outputs(proto, {"nope": a})
    with pytest.raises(KeyError):
        _per_output({"nope": a}, OUTPUTS)


def test_metric_names_eval_time_and_device_metrics(env):
    """One WER object on every output is named as the JAX engine names it
    (model.py:425-439, :843-857: over the output names in sorted order,
    "wer" first, then "wer_<output>"): the names and the value under each
    equal those of the JAX engine's host metric pass on the same outputs;
    `eval_time` times whole evaluations; a metric of the device's outputs
    is refused."""
    from avec_tpu.train.model import Model as JaxModel
    from avec_tpu_torch.train.metrics import CategoricalAccuracy

    trainer = _trainer(env)
    trainer.metrics = WordErrorRate()
    trainer.decoders = CTCGreedySearchDecoder(tokenizer_path=env["tok"])
    _, evals = _loaders(False)
    _, metrics, transcripts = trainer.evaluate(evals, eval_steps=1,
                                               recompute_metrics=True,
                                               return_transcripts=True)
    batch = next(iter(evals))
    trainer.model.eval()
    with torch.no_grad():
        inputs, _ = trainer._to_device(batch)
        outputs = trainer.model(*inputs)
    jmodel = JaxModel()
    jmodel.output_names = sorted(OUTPUTS)
    proto = {k: None for k in OUTPUTS}
    jmodel.metrics = jmodel.map_to_outputs(proto, JaxWER())
    jmodel.decoders = jmodel.map_to_outputs(
        proto, JaxGreedy(tokenizer_path=env["tok"]))
    pre = {k: jmodel.decoders[k].device_fn(
        tuple(jnp.asarray(o.numpy()) for o in outputs[k])) for k in OUTPUTS}
    want = jmodel._host_metric_pass(pre, batch["targets"])
    assert set(metrics) == set(want) == {"wer"} | {f"wer_{k}" for k in
                                                   sorted(OUTPUTS)[1:]}
    for k, (truths, preds, value) in want.items():
        assert transcripts[k] == (truths, preds), k
        assert metrics[k] == pytest.approx(value, rel=1e-12), k
        assert metrics[k] == WordErrorRate()(*transcripts[k])
    times = trainer.eval_time(evals, eval_steps=1, num_evals=2)
    assert set(times) == {"mean", "std", "min", "max"}
    assert 0 < times["min"] <= times["mean"] <= times["max"]
    with pytest.raises(ValueError, match="on_host"):
        Trainer(model=trainer.model, device="cpu",
                metrics={"outputs": CategoricalAccuracy()})
