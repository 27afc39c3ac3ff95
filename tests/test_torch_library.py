"""The rest of the port's library against the JAX package: the identity,
threshold and argmax decoders (alone and in `Trainer.evaluate`), the
auxiliary losses and infos that modules record (`ops/module_utils.py`)
through the trainer's step, accumulation included, the variational noise,
PCA, the initializer registry, and the package's exports.

fp32 on the CPU, small shapes. Tolerances: the aux-loss step's losses 1e-5
relative and parameters 1e-6; PCA's components up to sign, 1e-4; the
initializers' moments within 4 standard errors of their draws.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avec_tpu
from avec_tpu.decode import greedy as jgreedy
from avec_tpu.ops import inits as jinits
from avec_tpu.ops import pca as jpca
from avec_tpu.ops import variational_noise as jvn
from avec_tpu.train import losses as jlosses
from avec_tpu.train import optim as joptim
from avec_tpu_torch.decode import greedy as pgreedy
from avec_tpu_torch.models.zoo import ZooModel
from avec_tpu_torch.ops import inits as pinits
from avec_tpu_torch.ops import pca as ppca
from avec_tpu_torch.ops import variational_noise as pvn
from avec_tpu_torch.ops.layers import (Conv, ConvTranspose, Embedding, Linear,
                                       init_params)
from avec_tpu_torch.ops.module_utils import (add_info, add_loss,
                                             harvest_aux_losses)
from avec_tpu_torch.train.losses import MeanSquaredError
from avec_tpu_torch.train.model import Trainer
from avec_tpu_torch.train.optim import SGD

from test_module_hooks import AuxModel
from test_torch_support import REPO, t

torch.set_num_threads(1)


# ----------------------------------------------------------------- decoders

def test_simple_decoders_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 5).astype(np.float32)
    probs = rng.rand(4, 1).astype(np.float32)
    labels = rng.randint(0, 5, (4,)).astype(np.int32)
    pairs = [(jgreedy.IdentityDecoder(), pgreedy.IdentityDecoder(), logits),
             (jgreedy.ThresholdDecoder(0.4), pgreedy.ThresholdDecoder(0.4),
              probs),
             (jgreedy.ArgMaxDecoder(), pgreedy.ArgMaxDecoder(), logits),
             (jgreedy.ArgMaxDecoder(axis=0), pgreedy.ArgMaxDecoder(axis=0),
              logits)]
    for jd, pd, out in pairs:
        want = jd(np.asarray(jd.device_fn(jnp.asarray(out))))
        got = pd(pd.device_fn(t(out)))
        assert got == want
        assert pd(t(labels), from_logits=False) == jd(labels,
                                                     from_logits=False)
    assert pgreedy.ThresholdDecoder(0.4)(t(probs)) == np.where(
        probs >= 0.4, 1, 0)[:, 0].tolist()


class _Classifier(ZooModel):
    def __init__(self):
        super().__init__()
        self.linear = Linear(3, 5)
        self._finish_init("cpu", torch.Generator().manual_seed(0))

    def compile_defaults(self):
        return {"loss": None, "loss_weights": None, "metrics": None}

    def forward(self, x):
        return {"output": self.linear(x)}


class _Matches:
    """A host metric: the share of equal entries of two label lists."""
    on_host = True
    name = "matches"

    def __call__(self, truths, preds):
        return float(np.mean(np.asarray(truths) == np.asarray(preds)))


def test_argmax_decoder_in_trainer_evaluate():
    """The decoder's device part runs on the evaluation outputs, its host
    part on them and on the targets: the metric equals the accuracy of the
    argmax computed here."""
    model = _Classifier()
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss={}, metrics=_Matches(),
                      decoders=pgreedy.ArgMaxDecoder())
    rng = np.random.RandomState(1)
    batches = [{"inputs": [rng.randn(6, 3).astype(np.float32)],
                "targets": rng.randint(0, 5, (6,)).astype(np.int64)}
               for _ in range(2)]
    _, metrics = trainer.evaluate(batches)
    with torch.no_grad():
        want = np.mean([np.mean(model(t(b["inputs"][0]))["output"]
                                .argmax(-1).numpy() == b["targets"])
                        for b in batches])
    (value,) = metrics.values()
    assert value == pytest.approx(want)


# ------------------------------------------------------ aux losses, infos

class _NetWithAux(ZooModel):
    """The port of tests/test_module_hooks.py:NetWithAux."""

    def __init__(self):
        super().__init__()
        self.Linear_0 = Linear(3, 4)
        self.Linear_1 = Linear(4, 1)
        self._finish_init("cpu", torch.Generator().manual_seed(0))

    def compile_defaults(self):
        return {"loss": MeanSquaredError(), "loss_weights": None,
                "metrics": None}

    def forward(self, x):
        h = self.Linear_0(x)
        add_loss(self, "activity", (h ** 2).mean(), weight=0.5)
        add_info(self, "h_mean", h.mean())
        return {"output": self.Linear_1(h)}


def _jax_aux_step(batch, params, accumulated_steps):
    jmodel = AuxModel()
    jmodel.compile(losses=jlosses.MeanSquaredError(),
                   optimizer=joptim.SGD(lr=0.1, momentum=0.9))
    jmodel.build([batch["inputs"][0][:1]])
    jmodel.params = params
    jmodel.opt_state = jmodel.optimizer.init(params)
    step = jmodel._build_train_step(accumulated_steps, False)
    a = accumulated_steps
    micro = jax.tree.map(lambda x: x.reshape((a, -1) + x.shape[1:]),
                         {"inputs": [jnp.asarray(batch["inputs"][0])],
                          "targets": jnp.asarray(batch["targets"])})
    state, (losses, _, _) = step(jmodel._state(), micro, jax.random.PRNGKey(0))
    return losses, state["params"]


@pytest.mark.parametrize("accumulated_steps", [1, 2])
def test_aux_loss_harvest_matches_jax(accumulated_steps):
    """A module's add_loss joins the trainer's total with its weight and is
    reported as loss_activity; its add_info comes back in the step's infos;
    under accumulation each micro-batch harvests its own records. Losses
    1e-5 relative, parameters after one SGD step 1e-6."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3).astype(np.float32)
    batch = {"inputs": [x], "targets": x.sum(1, keepdims=True)}
    model = _NetWithAux()
    params = {f"Linear_{i}": {
        "kernel": getattr(model, f"Linear_{i}").weight.detach().numpy().T,
        "bias": getattr(model, f"Linear_{i}").bias.detach().numpy()}
        for i in range(2)}
    want_losses, want_params = _jax_aux_step(batch, params, accumulated_steps)
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      optimizer=SGD(lr=0.1, momentum=0.9))
    losses, infos = trainer.train_step(batch, accumulated_steps)
    assert set(losses) == set(want_losses) == {"loss", "loss_activity"}
    for k, w in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(w), rel=1e-5), k
    assert set(infos["module_infos"]) == {"h_mean"}
    for i in range(2):
        lin = getattr(model, f"Linear_{i}")
        np.testing.assert_allclose(lin.weight.detach().numpy().T,
                                   np.asarray(want_params[f"Linear_{i}"]
                                              ["kernel"]), rtol=1e-6,
                                   atol=1e-7)
    assert harvest_aux_losses(model) == {}       # cleared after the step


def test_module_infos_are_the_micro_batch_mean():
    model = _NetWithAux()
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      optimizer=SGD(lr=0.0))
    x = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    batch = {"inputs": [x], "targets": x.sum(1, keepdims=True)}
    _, infos = trainer.train_step(batch, accumulated_steps=2)
    with torch.no_grad():
        halves = [float(model.Linear_0(t(x[i:i + 4])).mean())
                  for i in (0, 4)]
    assert float(infos["module_infos"]["h_mean"]) == pytest.approx(
        np.mean(halves), rel=1e-6)


# ------------------------------------------------------- variational noise

def test_synaptic_noise_mask_and_statistics():
    """The default mask takes the weight matrices and kernels (the JAX
    package's `kernel` / `embedding` leaves) and no norm scale or bias; the
    noise on them has mean 0 and the given std; std 0 changes nothing."""
    net = torch.nn.ModuleDict({"lin": Linear(64, 128),
                               "conv": Conv(8, 16, 3, ndim=1),
                               "emb": Embedding(50, 32),
                               "norm": torch.nn.LayerNorm(16)})
    init_params(net, torch.Generator().manual_seed(0))
    mask = pvn.make_vn_mask(net)
    assert {k for k, v in mask.items() if v} == {
        "lin.weight", "conv.weight", "emb.weight"}
    jtree = {"lin": {"kernel": np.zeros((64, 128)), "bias": np.zeros(128)},
             "emb": {"embedding": np.zeros((50, 32))},
             "norm": {"scale": np.ones(16), "bias": np.zeros(16)}}
    jmask = jvn.make_vn_mask(jtree)
    assert (jmask["lin"]["kernel"], jmask["lin"]["bias"],
            jmask["emb"]["embedding"], jmask["norm"]["scale"]) == (
        True, False, True, False)
    gen = torch.Generator().manual_seed(3)
    noised = pvn.sample_synaptic_noise(net, gen, 0.05)
    params = dict(net.named_parameters())
    for name, p in params.items():
        diff = (noised[name] - p).detach()
        if mask[name]:
            n = diff.numel()
            assert abs(float(diff.mean())) < 4 * 0.05 / math.sqrt(n)
            assert float(diff.std()) == pytest.approx(0.05, rel=8 / math.sqrt(n))
        else:
            assert noised[name] is p
    assert pvn.sample_synaptic_noise(net, gen, 0.0) == params
    again = pvn.sample_synaptic_noise(net, torch.Generator().manual_seed(3),
                                      0.05)
    assert all(torch.equal(again[k], noised[k]) for k in noised)
    out = torch.func.functional_call(net["lin"], {
        "weight": noised["lin.weight"], "bias": noised["lin.bias"]},
        (torch.ones(1, 64),))
    assert out.shape == (1, 128)
    holder = type("Holder", (), {})()
    assert pvn.init_vn(holder, 0.1).vn_std == 0.1


# -------------------------------------------------------------------- PCA

def test_pca_matches_jax_up_to_sign():
    rng = np.random.RandomState(4)
    x = (rng.randn(200, 6) @ rng.randn(6, 6)).astype(np.float32)
    jp = jpca.PCA(n_components=3).fit(x)
    pp = ppca.PCA(n_components=3, device="cpu").fit(x)
    np.testing.assert_allclose(pp.explained_variance.numpy(),
                               np.asarray(jp.explained_variance), rtol=1e-4)
    got, want = pp.components.numpy(), np.asarray(jp.components)
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=1e-4)
    z = pp.transform(x).numpy()
    np.testing.assert_allclose(z * sign, np.asarray(jp.transform(x)),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(pp.inverse_transform(z).numpy(),
                               np.asarray(jp.inverse_transform(z * sign)),
                               rtol=0, atol=1e-3)
    full = ppca.PCA(device="cpu")
    np.testing.assert_allclose(full.inverse_transform(
        full.fit_transform(x)).numpy(), x, rtol=0, atol=1e-3)


# ------------------------------------------------------------------ inits

_SHAPES = [(64, 48), (32, 16, 3, 3), (24, 8, 5)]

# name -> (distribution, its bound (uniform) or std (normal) from the fans)
_DISTS = {
    "uniform": ("u", lambda fi, fo: 1.0),
    "normal": ("n", lambda fi, fo: 1.0),
    "scaled_uniform": ("u", lambda fi, fo: math.sqrt(1 / fi)),
    "scaled_normal": ("n", lambda fi, fo: math.sqrt(1 / fi)),
    "lecun_uniform": ("u", lambda fi, fo: math.sqrt(3 / fi)),
    "lecun_normal": ("n", lambda fi, fo: math.sqrt(1 / fi)),
    "he_uniform": ("u", lambda fi, fo: math.sqrt(6 / fi)),
    "he_normal": ("n", lambda fi, fo: math.sqrt(2 / fi)),
    "xavier_uniform": ("u", lambda fi, fo: math.sqrt(6 / (fi + fo))),
    "xavier_normal": ("n", lambda fi, fo: math.sqrt(2 / (fi + fo))),
    "normal_02": ("n", lambda fi, fo: 0.02),
    "default": ("u", lambda fi, fo: 1 / math.sqrt(fi)),
    "ones": ("c", lambda fi, fo: 1.0),
    "zeros": ("c", lambda fi, fo: 0.0),
}


def _jax_shape(shape):
    """The port's (out, in, *k) -> the JAX (*k, in, out)."""
    return tuple(shape[2:]) + (shape[1], shape[0])


@pytest.mark.parametrize("name", sorted(pinits.init_dict))
def test_inits_match_jax_by_support_and_moments(name):
    """Each named initializer: fans on the port's layouts equal the JAX
    fans of the same weight; the draws of the port and of the JAX
    initializer both have the distribution's support (a uniform's bound,
    reached to 5%) and standard deviation (5%), and mean 0 within 4
    standard errors."""
    assert set(_DISTS) == set(pinits.init_dict) == set(jinits.init_dict)
    kind, scale = _DISTS[name]
    for shape in _SHAPES:
        jshape = _jax_shape(shape)
        fans = pinits.compute_fans(shape)
        assert fans == jinits._compute_fans(jshape)
        s = scale(*fans)
        port = pinits.get_init(name)(torch.empty(shape),
                                     torch.Generator().manual_seed(0)).numpy()
        ref = np.asarray(jinits.get_init(name)(jax.random.PRNGKey(0), jshape))
        for w in (port, ref):
            if kind == "c":
                np.testing.assert_array_equal(w, np.full(w.shape, s))
                continue
            std = s / math.sqrt(3) if kind == "u" else s
            if kind == "u":
                assert s * 0.95 <= np.abs(w).max() <= s
            assert abs(w.mean()) <= 4 * std / math.sqrt(w.size)
            assert w.std() == pytest.approx(std, rel=0.05)


def test_layers_take_init_names_with_jax_fans():
    gen = torch.Generator().manual_seed(0)
    lin = Linear(400, 300, weight_init="he_uniform", bias_init="zeros")
    lin.init_(gen)
    assert float(lin.weight.detach().abs().max()) <= math.sqrt(6 / 400)
    assert not lin.bias.any()
    convt = ConvTranspose(40, 8, 5, ndim=1, weight_init="lecun_uniform")
    convt.init_(gen)
    # the JAX kernel (5, 40, 8): fan_in 200
    assert float(convt.weight.detach().abs().max()) <= math.sqrt(3 / 200)
    assert float(convt.weight.detach().abs().max()) > 0.9 * math.sqrt(3 / 200)
    assert float(convt.bias.detach().abs().max()) <= 1 / math.sqrt(200)
    emb = Embedding(1000, 16, embedding_init="xavier_uniform", padding_idx=0)
    emb.init_(gen)
    assert float(emb.weight.detach().abs().max()) <= math.sqrt(6 / 1016)
    assert not emb.weight[0].any()
    conv = Conv(16, 32, 3, ndim=2, bias=False)
    conv.init_(gen)                       # bias-free: he-normal by default
    assert float(conv.weight.detach().std()) == pytest.approx(math.sqrt(2 / 144),
                                                     rel=0.05)


# ---------------------------------------------------------------- exports

def _jax_public_names():
    src = (REPO / "avec_tpu" / "__init__.py").read_text()
    import ast

    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_every_public_name_has_its_counterpart():
    """Every name that avec_tpu/__init__.py imports is exported by the port
    under the same name, apart from the two documented renames."""
    import avec_tpu_torch

    names = _jax_public_names()
    assert {"Model", "mesh", "ctc_loss", "RNNTLoss", "SGD"} <= names
    assert avec_tpu_torch.RENAMED == {"Model": "Trainer", "mesh": "dist"}
    missing = [n for n in names
               if not hasattr(avec_tpu_torch, avec_tpu_torch.RENAMED.get(n, n))]
    assert not missing, missing
    assert set(names) <= set(dir(avec_tpu)) | {"data"}
    from avec_tpu_torch.ops import ctc
    assert avec_tpu_torch.ctc_loss is ctc.ctc_loss


def test_package_import_needs_no_jax_and_no_cuda():
    code = ("import sys, torch, avec_tpu_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'avec_tpu')]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
