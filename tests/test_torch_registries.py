"""The names the JAX `compile` takes, and checkpoint surgery, in the port
vs the JAX package.

  * every registry of the JAX package (`loss_dict`, `metric_dict`,
    `optim_dict`, `scheduler_dict`, `decoder_dict`, `model_dict`) has its
    port counterpart with every key, and `Trainer(loss=, metrics=,
    optimizer=, decoders=)` builds from a name what the JAX `compile`
    builds (avec_tpu/train/model.py:174-197): `loss_dict[name]()`,
    `metric_dict[name]()`, `decoder_dict[name]()`, `optim_dict[name](lr=
    0.001)`, and the model's own optimizer for the name of its default
    ("Adam" on the conformer models, "AdamW" on the GPT);
  * `state_dict_flatten`, `state_dict_unflatten` and `restore_tree` on the
    flattened variables of a small AO model give the JAX functions' keys
    and values: a flat round trip, a rename that drops keys (non-strict:
    the template's values kept), strict mode's missing and unexpected keys,
    a shape that differs; and `Trainer.load(rename=, select=, strict=)`
    through `restore_tree`.
"""

import jax
import numpy as np
import pytest
import torch

from avec_tpu import decode as jdecode
from avec_tpu.models import zoo as jzoo
from avec_tpu.train import checkpoint as jckpt
from avec_tpu.train import losses as jlosses
from avec_tpu.train import metrics as jmetrics
from avec_tpu.train import optim as joptim
from avec_tpu.train import schedulers as jsched
from avec_tpu_torch import decode
from avec_tpu_torch.models import zoo
from avec_tpu_torch.train import checkpoint, losses, metrics, optim
from avec_tpu_torch.train import schedulers
from avec_tpu_torch.train.model import Trainer

from test_torch_support import random_variables

torch.set_num_threads(1)

AO = dict(vocab_size=16, num_blocks=(1, 1, 1), interctc_blocks=(1,))


@pytest.mark.parametrize("port,jax_", [
    (losses.loss_dict, jlosses.loss_dict),
    (metrics.metric_dict, jmetrics.metric_dict),
    (optim.optim_dict, joptim.optim_dict),
    (schedulers.scheduler_dict, jsched.scheduler_dict),
    (decode.decoder_dict, jdecode.decoder_dict),
    (zoo.model_dict, jzoo.model_dict)])
def test_registries_have_every_jax_key(port, jax_):
    assert set(jax_) <= set(port)
    for name, cls in jax_.items():
        assert port[name].__name__ == cls.__name__, name


def test_trainer_takes_registry_names():
    model = zoo.AudioEfficientConformerInterCTC(device="cpu", **AO)
    tr = Trainer(model=model, device="cpu", precision="float32", loss="CTC",
                 metrics="WordErrorRate", optimizer="SGD",
                 decoders="Identity")
    assert type(tr.loss) is losses.CTCLoss
    assert vars(tr.loss) == vars(losses.CTCLoss())
    assert type(tr.metrics) is metrics.WordErrorRate
    assert type(tr.decoders) is decode.decoder_dict["Identity"]
    opt = tr.optimizer.optimizer
    assert type(opt) is torch.optim.SGD
    assert tr.optimizer.learning_rate(0) == 0.001
    # "Adam", the conformer models' default name: the Noam-scheduled Adam
    tr = Trainer(model=model, device="cpu", precision="float32",
                 optimizer="Adam")
    want = optim.noam_adam(model)
    assert type(tr.optimizer.optimizer) is torch.optim.Adam
    for step in (0, 10, 20000):
        assert tr.optimizer.learning_rate(step) == want.learning_rate(step)
    assert (tr.optimizer.optimizer.defaults["betas"]
            == want.optimizer.defaults["betas"] == (0.9, 0.98))
    # on the GPT "AdamW" is its recipe, "Adam" the registry's Adam at 0.001
    gpt = zoo.GPT(device="cpu", vocab_size=32, model="GPT-Tiny",
                  max_pos_encoding=16)
    tr = Trainer(model=gpt, device="cpu", precision="float32",
                 optimizer="AdamW", loss="SoftmaxCrossEntropy",
                 metrics="CategoricalAccuracy")
    recipe = gpt.compile_defaults()["optimizer"](gpt)
    assert type(tr.optimizer.optimizer) is torch.optim.AdamW
    assert len(tr.optimizer.optimizer.param_groups) == 2
    assert tr.optimizer.learning_rate(100) == recipe.learning_rate(100)
    assert type(tr.metrics) is metrics.CategoricalAccuracy
    tr = Trainer(model=gpt, device="cpu", precision="float32",
                 optimizer="Adam")
    assert type(tr.optimizer.optimizer) is torch.optim.Adam
    assert tr.optimizer.learning_rate(100) == 0.001


@pytest.fixture(scope="module")
def variables():
    jmodel = jzoo.AudioEfficientConformerInterCTC(**AO)
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, np.zeros((1, 16000), np.float32),
        np.array([16000], np.int32), training=False))
    params, stats = random_variables(shapes, seed=0)
    return {"params": params, "batch_stats": stats}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_flatten_and_unflatten_match_jax(variables):
    want = jckpt.state_dict_flatten(variables)
    got = checkpoint.state_dict_flatten(variables)
    _same(got, want)
    torch_tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                              variables)
    _same(checkpoint.state_dict_flatten(torch_tree), want)
    assert checkpoint.state_dict_flatten(None) == jckpt.state_dict_flatten(
        None) == {}
    back = checkpoint.state_dict_unflatten(got)
    _same(checkpoint.state_dict_flatten(back),
          jckpt.state_dict_flatten(jckpt.state_dict_unflatten(want)))


def _drop_bn(key):
    """A rename that drops the batch statistics."""
    return None if key.startswith("batch_stats.") else key


def test_restore_tree_matches_jax(variables):
    flat = jckpt.state_dict_flatten(variables)
    rng = np.random.RandomState(1)
    incoming = {k: (v + rng.randn(*v.shape).astype(v.dtype)
                    if v.dtype.kind == "f" else v) for k, v in flat.items()}
    for rename, strict in ((None, True), (_drop_bn, False)):
        want = jckpt.state_dict_flatten(jckpt.restore_tree(
            variables, incoming, strict=strict, rename=rename))
        got = checkpoint.state_dict_flatten(checkpoint.restore_tree(
            variables, incoming, strict=strict, rename=rename))
        _same(got, want)
    # the dropped keys kept the template's values
    kept = [k for k in flat if k.startswith("batch_stats.")]
    assert kept and all(np.array_equal(got[k], flat[k]) for k in kept)
    # a torch template keeps its type and dtype
    template = {k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()}
    out = checkpoint.restore_tree(template, incoming, strict=True)
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    _same({k: v.numpy() for k, v in out.items()}, incoming)
    # strict: a missing key, an unexpected key; any mode: a shape mismatch
    for fn in (jckpt.restore_tree, checkpoint.restore_tree):
        some = dict(list(incoming.items())[1:])
        with pytest.raises(KeyError, match="missing"):
            fn(variables, some, strict=True)
        with pytest.raises(KeyError, match="unexpected"):
            fn(variables, {**incoming, "params.extra": np.zeros(1)},
               strict=True)
        k0 = next(iter(incoming))
        with pytest.raises(ValueError, match="shape"):
            fn(variables, {k0: np.zeros((3, 3, 3))}, strict=False)


def test_trainer_load_renames_through_restore_tree(tmp_path):
    """A rename that returns None drops keys: non-strict, the model keeps
    its own values for them; strict, the load raises; `select` and `rename`
    together load one part under another name."""
    src = zoo.AudioEfficientConformerInterCTC(
        device="cpu", generator=torch.Generator().manual_seed(1), **AO)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():          # LayerNorms off their init of ones
        for p in src.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    path = str(tmp_path / "src.ckpt")
    Trainer(model=src, device="cpu", precision="float32").save(path)
    model = zoo.AudioEfficientConformerInterCTC(device="cpu", **AO)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model=model, device="cpu", precision="float32")
    drop = lambda k: None if k.startswith("encoder.head.") else k  # noqa: E731
    with pytest.raises(KeyError, match="missing"):
        tr.load(path, strict=True, rename=drop)
    tr.load(path, strict=False, rename=drop)
    for k, v in model.state_dict().items():
        want = before[k] if k.startswith("encoder.head.") else src.state_dict()[k]
        assert torch.equal(v, want), k
    assert any(k.startswith("encoder.head.") for k in before)
    # the first block's attention LayerNorm loaded into its FFN's
    # LayerNorm, nothing else moved
    model2 = zoo.AudioEfficientConformerInterCTC(device="cpu", **AO)
    before = {k: v.clone() for k, v in model2.state_dict().items()}
    tr2 = Trainer(model=model2, device="cpu", precision="float32")
    block = "encoder.back_end.conformer_blocks.0."
    moved = {block + "ff_module1.layers.0." + w: block
             + "self_att_module.norm." + w for w in ("weight", "bias")}
    tr2.load(path, select=lambda k: k in moved.values(),
             rename=lambda k: {v: d for d, v in moved.items()}[k])
    for k, v in model2.state_dict().items():
        want = src.state_dict()[moved[k]] if k in moved else before[k]
        assert torch.equal(v, want), k
    assert not torch.equal(before[next(iter(moved))],
                           src.state_dict()[next(iter(moved.values()))])
