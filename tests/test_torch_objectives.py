"""The port's objectives and optimizers against the JAX package: the CTC
recursion (`ops/ctc.py:ctc_forward_score`, the functional `ctc_loss`) and
the RNN-T loss with their gradients (the RNN-T loss also against the
brute-force lattice of `tests/test_rnnt.py`), the regression losses and
their reductions, the SGD and RMSprop optimizers over five steps, and every
scheduler.

fp32 on the CPU, small shapes. Tolerances: losses 1e-4 relative (CTC and
RNN-T 1e-5 against JAX), gradients 1e-5 of their largest entry (RNN-T
1e-4), parameters after the optimizer steps 1e-6 relative, schedules 1e-7
relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from avec_tpu.ops import ctc as jctc
from avec_tpu.ops import rnnt as jrnnt
from avec_tpu.train import losses as jlosses
from avec_tpu.train import optim as joptim
from avec_tpu.train import schedulers as jsched
from avec_tpu_torch.ops import ctc as pctc
from avec_tpu_torch.ops import rnnt as prnnt
from avec_tpu_torch.train import losses as plosses
from avec_tpu_torch.train import optim as poptim
from avec_tpu_torch.train import schedulers as psched

from test_rnnt import _brute_force_rnnt
from test_torch_support import t

torch.set_num_threads(1)


def _ctc_case(seed=0, b=4, t_len=14, v=7, u=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t_len, v).astype(np.float32)
    lengths = np.array([t_len, 11, 6, 3][:b], np.int32)
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    labels[0, 2] = labels[0, 1]                  # a repeat: no skip there
    label_lengths = np.array([5, 3, 0, 4][:b], np.int32)  # the last infeasible
    return logits, lengths, labels, label_lengths


@pytest.mark.parametrize("reduction", ["none", "mean", "sum", "default"])
@pytest.mark.parametrize("zero_infinity", [False, True])
def test_ctc_loss_and_gradient_match_jax(reduction, zero_infinity):
    """The JAX recursion and its alpha-beta gradient: loss 1e-5 relative,
    gradient 1e-5 of its largest entry; an infeasible sample (4 labels in 3
    frames) at about 1e30, or 0 with a zero gradient with zero_infinity.
    Without zero_infinity the infeasible sample's gradient has no meaning
    (the JAX posterior of an empty lattice, autograd's of -1e30 sums), so
    the gradients are compared on the feasible samples."""
    logits, lengths, labels, label_lengths = _ctc_case()
    kw = dict(reduction=reduction, zero_infinity=zero_infinity)
    if not zero_infinity and reduction != "none":
        logits, lengths = logits[:3], lengths[:3]
        labels, label_lengths = labels[:3], label_lengths[:3]

    def jloss(x):
        out = jctc.ctc_loss(x, lengths, labels, label_lengths, **kw)
        return out.sum(), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(logits)
    x = t(logits).requires_grad_(True)
    got = pctc.ctc_loss(x, t(lengths), t(labels), t(label_lengths), **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    jgrad = np.asarray(jgrad)[:3]
    err = np.abs(x.grad.numpy()[:3] - jgrad).max()
    assert err <= 1e-5 * np.abs(jgrad).max(), err
    if zero_infinity:
        assert not x.grad[3].any()


def test_ctc_forward_score_matches_torch_ctc_loss():
    """The same NLL as the library's CTC (reduction "none") on feasible
    samples, 1e-5 relative."""
    logits, lengths, labels, label_lengths = _ctc_case(seed=1)
    lp = torch.log_softmax(t(logits), -1)
    got = pctc.ctc_forward_score(lp, t(lengths), t(labels),
                                 t(label_lengths))
    want = F.ctc_loss(lp.transpose(0, 1), t(labels).long(), t(lengths).long(),
                      t(label_lengths).long(), reduction="none")
    np.testing.assert_allclose(got[:3].numpy(), want[:3].numpy(), rtol=1e-5)
    assert float(got[3]) > 1e29


def _rnnt_case(seed, b=3, t_len=9, u=4, v=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t_len, u + 1, v).astype(np.float32)
    lengths = np.array([t_len, 6, 5][:b], np.int32)
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    label_lengths = np.array([4, 2, 0][:b], np.int32)
    return logits, lengths, labels, label_lengths


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_rnnt_loss_and_gradient_match_jax(seed, reduction):
    """Loss 1e-5 relative against JAX and 1e-4 against the brute-force
    lattice; gradient 1e-4 of its largest entry against JAX's autodiff."""
    logits, lengths, labels, label_lengths = _rnnt_case(seed)

    def jloss(x):
        out = jrnnt.rnnt_loss(x, lengths, labels, label_lengths,
                              reduction=reduction)
        return out.sum(), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(logits)
    x = t(logits).requires_grad_(True)
    got = prnnt.rnnt_loss(x, t(lengths), t(labels), t(label_lengths),
                          reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    jgrad = np.asarray(jgrad)
    err = np.abs(x.grad.numpy() - jgrad).max()
    assert err <= 1e-4 * np.abs(jgrad).max(), err
    if reduction == "none":
        lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
        brute = [_brute_force_rnnt(lp[i], int(lengths[i]), labels[i],
                                   int(label_lengths[i]))
                 for i in range(len(lengths))]
        np.testing.assert_allclose(got.detach().numpy(), brute, rtol=1e-4,
                                   atol=1e-4)


def test_rnnt_gradient_at_full_length_is_close_to_fp64():
    """At the AO step's length (T = 151, U = 32, V = 256) the fp32 gradient
    stays within 5e-5 of its largest entry from the same recursion in
    fp64: each frame's row is kept relative to its u = 0 entry (without
    that the rows reach about -800 and the gradient is 1.3e-4 off)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 151, 33, 256).astype(np.float32)
    args = (torch.tensor([151, 120]), t(rng.randint(1, 256, (2, 32))),
            torch.tensor([32, 25]))

    def grad(dtype):
        x = t(logits).to(dtype).requires_grad_(True)
        prnnt.rnnt_forward_score(torch.log_softmax(x, -1), *args).sum(
            ).backward()
        return x.grad.double().numpy()

    g64, g32 = grad(torch.float64), grad(torch.float32)
    assert np.abs(g32 - g64).max() <= 5e-5 * np.abs(g64).max()


def test_rnnt_loss_class():
    logits, lengths, labels, label_lengths = _rnnt_case(2)
    want = jrnnt.RNNTLoss()((labels, label_lengths), (logits, lengths))
    got = prnnt.RNNTLoss()((t(labels), t(label_lengths)),
                           (t(logits), t(lengths)))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def _loss_cases():
    rng = np.random.RandomState(3)
    y_pred = rng.randn(4, 5).astype(np.float32)
    y_sign = rng.choice([-1.0, 1.0], (4, 5)).astype(np.float32)
    y_real = rng.randn(4, 5).astype(np.float32)
    y_cls = rng.randint(0, 5, (4,)).astype(np.int32)
    mask = (rng.rand(4, 5) > 0.4).astype(np.float32)
    return [
        ("MeanLoss", {}, y_sign, y_pred),
        ("MeanLoss", {"targets_as_sign": False}, y_sign, y_pred),
        ("MeanLoss", {"targets": 1.0}, None, y_pred),
        ("HingeLoss", {"margin": 0.5}, y_sign, y_pred),
        ("HingeLoss", {"targets": -1.0}, None, y_pred),
        ("MeanAbsoluteError", {}, y_real, y_pred),
        ("MeanAbsoluteError", {"masked": True}, y_real, (y_pred, mask)),
        ("MeanAbsoluteError", {"convert_one_hot": True}, y_cls, y_pred),
        ("MeanSquaredError", {"factor": 0.5}, y_real, y_pred),
        ("MeanSquaredError", {"convert_one_hot": True}, y_cls, y_pred),
        ("MeanSquaredError", {"targets": 0.25}, None, y_pred),
        ("HuberLoss", {"delta": 0.7, "factor": 2.0}, y_real, y_pred),
        ("HuberLoss", {"convert_one_hot": True}, y_cls, y_pred),
    ]


@pytest.mark.parametrize("reduction", ["sum", "mean", "mean_batch"])
@pytest.mark.parametrize("case", range(13))
def test_regression_losses_match_jax(case, reduction):
    name, kw, y, out = _loss_cases()[case]
    want = getattr(jlosses, name)(reduction=reduction, **kw)(
        None if y is None else jnp.asarray(y),
        tuple(jnp.asarray(o) for o in out) if isinstance(out, tuple)
        else jnp.asarray(out))
    got = getattr(plosses, name)(reduction=reduction, **kw)(
        None if y is None else t(y),
        tuple(t(o) for o in out) if isinstance(out, tuple) else t(out))
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-7)


def test_reduction_rejects_unknown_names():
    with pytest.raises(ValueError):
        plosses.Reduction("default")
    x = torch.arange(6.0).reshape(2, 3)
    assert float(plosses.Reduction("mean_batch")(x)) == 7.5
    assert float(plosses.Reduction("mean")(x, n_elt=3)) == 5.0


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.1, momentum=0.9)),
    ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-2)),
    ("SGD", dict(lr=0.1, momentum=0.9, dampening=0.5)),
    ("RMSprop", dict(lr=0.01)),
    ("RMSprop", dict(lr=0.01, momentum=0.9, weight_decay=1e-2, eps=1e-6)),
    ("SGD", dict(lr=jsched.ExpDecayScheduler(2, 0.1, 0.5, 10),
                 momentum=0.9, nesterov=True)),
])
def test_optimizers_match_optax(name, kw):
    """Five steps on the same gradients: every parameter within 1e-6
    relative of the JAX optimizer's (an optax chain)."""
    rng = np.random.RandomState(7)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    jopt = getattr(joptim, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    for step, g in enumerate(grads):
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 state, jp, step)
        jp = optax.apply_updates(jp, upd)
    pkw = dict(kw)
    if isinstance(pkw["lr"], jsched.Scheduler):
        s = pkw["lr"]
        pkw["lr"] = psched.ExpDecayScheduler(s.warmup_steps, s.val_max,
                                             s.alpha, s.end_step)
    tp = [torch.nn.Parameter(t(params[k])) for k in ("w", "b")]
    opt = getattr(poptim, name)(**pkw)(tp)
    for step, g in enumerate(grads):
        for p, k in zip(tp, ("w", "b")):
            p.grad = t(g[k])
        opt.update(step)
    for p, k in zip(tp, ("w", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    assert set(poptim.optim_dict) == set(joptim.optim_dict)


def test_rmsprop_state_survives_a_state_dict_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = poptim.RMSprop(lr=0.1, momentum=0.5)([p])
    p.grad = torch.full((3,), 0.5)
    opt.update(0)
    state = copy.deepcopy(opt.optimizer.state_dict())
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = poptim.RMSprop(lr=0.1, momentum=0.5)([q])
    opt2.optimizer.load_state_dict(state)
    for o, param in ((opt, p), (opt2, q)):
        param.grad = torch.full((3,), 0.25)
        o.update(1)
    torch.testing.assert_close(p, q, rtol=0, atol=0)


_SCHEDULERS = [
    ("ConstantScheduler", (0.3,)),
    ("ConstantDecayScheduler", ([1.0, 0.5, 0.1], [100, 5000])),
    ("WarmupConstantDecayScheduler", (500, [1.0, 0.5, 0.1], [1000, 8000])),
    ("LinearDecayScheduler", (1.0, 0.1, 7000)),
    ("NoamDecayScheduler", (10000, 360, 2)),
    ("ExpDecayScheduler", (1000, 1e-3, 0.01, 9000)),
    ("CosineAnnealingScheduler", (750, 6e-4, 6e-5, 9000)),
]


@pytest.mark.parametrize("name,args", _SCHEDULERS)
def test_schedulers_match_jax(name, args):
    """Every step 0-10 000, 1e-7 relative."""
    js = getattr(jsched, name)(*args)
    ps = getattr(psched, name)(*args)
    assert isinstance(ps, psched.Scheduler)
    for step in range(10001):
        assert ps(step) == pytest.approx(js(step), rel=1e-7, abs=0), step
    assert set(psched.scheduler_dict) == set(jsched.scheduler_dict)
