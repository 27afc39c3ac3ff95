"""Training-mode layers, the CTC loss and the Noam schedule of the port vs
the JAX package, fp32 on the CPU, numpy inputs from a seed.

Tolerances: train BatchNorm output and running statistics 1e-5; CTC loss
values 1e-4 relative and logit gradients 1e-5 absolute (two different exact
algorithms in fp32); Noam values 1e-12 relative (same formula in doubles).
Dropout and SpecAugment use another random stream than JAX's, so they are
held by keep rate, scaling, mask counts and widths, not by values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.ops import layers as jl
from avec_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from avec_tpu.train.schedulers import NoamDecayScheduler as JaxNoam
from avec_tpu_torch.ops.audio import SpecAugment
from avec_tpu_torch.ops.layers import BatchNorm, Conv, Dropout
from avec_tpu_torch.train.losses import CTCLoss, ctc_loss
from avec_tpu_torch.train.schedulers import NoamDecayScheduler

from test_torch_support import t

torch.set_num_threads(1)


def test_train_batchnorm_matches_jax_over_two_calls():
    """Output with batch statistics, and the running mean / unbiased
    running variance after two calls (momentum 0.9 flax = 0.1 torch)."""
    rng = np.random.RandomState(0)
    xs = [(rng.randn(3, 7, 5, 6) * 2 + 1).astype(np.float32) for _ in range(2)]
    params = {"scale": (1 + 0.1 * rng.randn(6)).astype(np.float32),
              "bias": (0.1 * rng.randn(6)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.randn(6)).astype(np.float32),
             "var": (rng.rand(6) + 0.5).astype(np.float32)}
    bn = BatchNorm(6).train()
    bn.load_state_dict({"weight": t(params["scale"]), "bias": t(params["bias"]),
                        "running_mean": t(stats["mean"]),
                        "running_var": t(stats["var"])})
    jbn = jl.BatchNorm()
    for x in xs:
        want, mut = jbn.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = bn(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5, rtol=0)
    bn.eval()
    before = bn.running_mean.clone()
    bn(t(xs[0]).permute(0, 3, 1, 2))
    assert torch.equal(bn.running_mean, before)       # eval moves nothing


def test_train_batchnorm_gradient_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 9, 5).astype(np.float32)
    g = rng.randn(4, 9, 5).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.randn(5)).astype(np.float32),
              "bias": np.zeros(5, np.float32)}
    stats = {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}

    def loss(x, params):
        y, _ = jl.BatchNorm().apply(
            {"params": params, "batch_stats": stats}, x,
            use_running_average=False, mutable=["batch_stats"])
        return (y * g).sum()

    want_x, want_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    bn = BatchNorm(5).train()
    with torch.no_grad():
        bn.weight.copy_(t(params["scale"]))
    xt = t(x).requires_grad_(True)
    (bn(xt.transpose(1, 2)).transpose(1, 2) * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(want_p["scale"]), atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(want_p["bias"]), atol=1e-4)


def test_detached_conv_bias_has_exactly_zero_gradient():
    """A conv feeding a train-mode BN: bias_stop_gradient leaves the bias
    without a gradient in training (autograd alone gives rounding noise),
    and the forward value is unchanged; eval keeps the bias differentiable."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 30, generator=gen)
    outs = {}
    for stop in (False, True):
        conv = Conv(4, 4, 5, ndim=1, groups=4, bias_stop_gradient=stop)
        conv.init_(torch.Generator().manual_seed(1))
        bn = BatchNorm(4)
        conv.train(), bn.train()
        y = bn(conv(x))
        (y * torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
         ).sum().backward()
        outs[stop] = (y.detach(), conv.bias.grad, conv.weight.grad)
    assert torch.equal(outs[False][0], outs[True][0])
    assert outs[True][1] is None and outs[True][2] is not None
    assert outs[False][1] is not None
    assert float(outs[False][1].abs().max()) < 1e-4   # analytically zero
    conv.eval()
    conv(x).sum().backward()
    assert conv.bias.grad is not None


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    drop = Dropout(rate).train()
    drop.generator = torch.Generator().manual_seed(3)
    x = torch.ones(200, 500)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / (1 - rate), rtol=1e-6)
    again = Dropout(rate).train()
    again.generator = torch.Generator().manual_seed(3)
    assert torch.equal(again(x), y)                   # seeded
    assert torch.equal(drop.eval()(x), x)
    drop.train().regularize = False
    assert torch.equal(drop(x), x)


def test_specaugment_mask_counts_and_widths():
    """mF=2 frequency masks of width <= F shared by the batch; mT=5 time
    masks per sample, each <= floor(pS * length) wide, inside the valid
    frames only; masked entries are 0 and the rest is untouched."""
    aug = SpecAugment(mF=2, F=27, mT=5, pS=0.05).train()
    aug.generator = torch.Generator().manual_seed(4)
    b, n_mels, tt = 6, 80, 400
    lengths = torch.tensor([400, 400, 300, 200, 100, 10])
    x = torch.randn(b, n_mels, tt, generator=torch.Generator().manual_seed(5))
    x = x + 10.0                                      # no natural zeros
    seen_freq, seen_time = set(), set()
    for _ in range(20):
        y = aug(x, lengths)
        masked = y == 0
        assert torch.equal(y[~masked], x[~masked])
        # frequency rows are masked over all frames, the same per sample
        cand = masked[:, :, :10].all(dim=2)
        assert torch.equal(cand[0], cand[5])          # shared by the batch
        n_f = int(cand[0].sum())
        assert n_f <= 2 * 27
        seen_freq.add(n_f)
        for i in range(b):
            cols = masked[i][~cand[i]].all(dim=0) if (~cand[i]).any() else \
                masked[i].all(dim=0)
            n = int(lengths[i])
            assert not bool(cols[n:].any())           # never past the length
            assert int(cols.sum()) <= 5 * int(0.05 * n)
            seen_time.add(int(cols.sum()))
    assert len(seen_freq) > 3 and max(seen_time) > 20 and min(seen_time) == 0
    assert torch.equal(aug.eval()(x, lengths), x)


def test_specaugment_band_statistics_match_jax():
    """Frequency bands come from `band_generator` alone, time masks from
    `generator`: two time-mask streams give the same bands. Over 400 draws
    the count of masked mel rows per draw keeps the JAX package's range
    (0 .. mF F) and mean (within 4 standard errors of the difference)."""
    from avec_tpu.ops.audio import SpecAugment as JaxSpecAugment

    b, n_mels, tt, draws = 2, 80, 50, 400
    lengths = torch.tensor([50, 30])

    def port_masks(time_seed):
        aug = SpecAugment(mF=2, F=27, mT=5, pS=0.05).train()
        aug.band_generator = torch.Generator().manual_seed(11)
        aug.generator = torch.Generator().manual_seed(time_seed)
        return torch.stack([~aug.keep_mask(b, n_mels, tt, lengths)
                            for _ in range(draws)])

    m1, m2 = port_masks(1), port_masks(2)
    assert torch.equal(m1.all(dim=3), m2.all(dim=3))
    assert not torch.equal(m1, m2)
    port = m1[:, 0].all(dim=2).sum(dim=1).double().numpy()
    jaug = JaxSpecAugment(mF=2, F=27, mT=5, pS=0.05)
    x = jnp.ones((b, n_mels, tt), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    y = jax.vmap(lambda k: jaug(x, jnp.asarray(lengths.numpy()), k))(keys)
    ref = np.asarray((y[:, 0] == 0).all(axis=2).sum(axis=1), np.float64)
    for counts in (port, ref):
        assert counts.min() >= 0 and counts.max() <= 2 * 27
    se = np.sqrt(port.var() / draws + ref.var() / draws)
    assert abs(port.mean() - ref.mean()) <= 4 * se, (port.mean(), ref.mean())


@pytest.mark.parametrize("fused_ffn", [False, None])
def test_unfused_ffn_training_drops_inner_and_outer(fused_ffn, monkeypatch):
    """With the fused route off (explicitly, or by AVEC_TPU_FUSED_FFN unset)
    a training-mode FeedForwardModule runs the unfused layers with its
    Dropout on the inner activation and on the output, as the JAX module
    does (conformer.py:130-139), drawing from the generator the model sets:
    the same seed gives the same output; with dropout off it is the eval
    output."""
    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops.layers import init_params

    monkeypatch.delenv("AVEC_TPU_FUSED_FFN", raising=False)
    ffn = init_params(FeedForwardModule(16, 64, 0.5, fused_ffn=fused_ffn),
                      torch.Generator().manual_seed(0)).train()
    assert not ffn.fused_eligible()
    calls = []
    ffn.dropout.register_forward_hook(lambda m, i, o: calls.append((i[0], o)))
    x = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(1))
    ffn.dropout.generator = torch.Generator().manual_seed(5)
    y = ffn(x)
    assert [o.shape[-1] for _, o in calls] == [64, 16]
    for i, o in calls:
        kept = o != 0
        assert torch.allclose(o[kept], 2.0 * i[kept])     # scaled by 1 / keep
        assert 0.3 < float(kept.float().mean()) < 0.7
    ffn.dropout.generator = torch.Generator().manual_seed(5)
    assert torch.equal(ffn(x), y)
    ffn.dropout.regularize = False
    y_off = ffn(x)
    assert torch.equal(y_off, ffn.eval()(x))


def _ctc_case(seed=0, b=4, tt=30, v=12, u=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, tt, v).astype(np.float32)
    logit_len = np.array([30, 25, 18, 4], np.int32)
    labels = rng.randint(1, v, size=(b, u)).astype(np.int32)
    label_len = np.array([7, 5, 3, 7], np.int32)      # the last is infeasible
    return logits, logit_len, labels, label_len


@pytest.mark.parametrize("reduction", ["mean", "sum", "default", "none"])
def test_ctc_loss_matches_jax(reduction):
    """Values and logit gradients for every reduction, with an infeasible
    sample (7 labels in 4 frames) under zero_infinity."""
    logits, logit_len, labels, label_len = _ctc_case()

    def jloss(lg):
        out = jax_ctc_loss(lg, jnp.asarray(logit_len), jnp.asarray(labels),
                           jnp.asarray(label_len), reduction=reduction,
                           zero_infinity=True)
        return out.sum(), out

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    lt = t(logits).requires_grad_(True)
    got = ctc_loss(lt, t(logit_len), t(labels), t(label_len),
                   reduction=reduction, zero_infinity=True)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-5)
    assert float(lt.grad[3].abs().max()) == 0.0       # infeasible: no gradient
    if reduction == "none":
        assert float(got.detach()[3]) == 0.0 and got.shape == (4,)


def test_ctc_loss_class_and_bf16_logits():
    logits, logit_len, labels, label_len = _ctc_case(1)
    loss = CTCLoss(reduction="default", zero_infinity=True)
    want = loss((t(labels), t(label_len)), (t(logits), t(logit_len)))
    got = loss((t(labels), t(label_len)),
               (t(logits).bfloat16(), t(logit_len)))
    assert got.dtype == torch.float32                 # computed in fp32
    assert abs(float(got) - float(want)) < 0.05 * abs(float(want))
    with pytest.raises(ValueError):
        CTCLoss(reduction="none")


@pytest.mark.parametrize("step", [0, 1, 9999, 10000, 50000])
def test_noam_schedule_matches_jax(step):
    want = JaxNoam(10000, 360, 2)(step)
    got = NoamDecayScheduler(10000, 360, 2)(step)
    assert got == pytest.approx(want, rel=1e-12)
    if step == 10000:
        assert got == pytest.approx(2 * 360 ** -0.5 * 10000 ** -0.5, rel=1e-12)
