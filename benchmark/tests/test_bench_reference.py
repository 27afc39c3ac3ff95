"""The benchmark's plain reference against the port's plain path (the fused
modules' plain versions on the CPU) at small depths on the same weights:
eval logits, and one training step's losses and gradients with the same
dropout, hash masks and SpecAugment draws."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import weights  # noqa: E402
from benchmark.families import avec  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

SPECS = {
    "av": dict(kind="av", vocab_size=32, v_num_blocks=[1, 1],
               a_num_blocks=[1, 2, 1], f_num_blocks=1, v_interctc_blocks=[1],
               a_interctc_blocks=[1, 3], f_interctc_blocks=[1],
               att_type="patch"),
    "ao": dict(kind="ao", vocab_size=32, a_num_blocks=[2, 1, 1],
               a_interctc_blocks=[2], att_type="patch"),
}
ROUTE = dict(fused_ffn=True, fused_att=True, fused_conv=True,
             stem_mode="pallas", use_flash=False)
SERVE = dict(ROUTE, use_flash=True)
TRAIN = dict(betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6,
             noam=(10000, 360, 2.0), accumulated_steps=2,
             loss_weights={"outputs": 0.5})


def _batch(kind, seed, n=4):
    rng = np.random.default_rng(seed)
    secs = rng.uniform(0.5, 1.0, n)
    ns = (secs * 16000).astype(np.int64)
    audio = torch.zeros((n, int(ns.max())))
    for i, k in enumerate(ns):
        audio[i, :k] = torch.from_numpy(rng.standard_normal(k) * 0.1)
    vf = ns // 640 + 1
    video = torch.zeros((n, int(vf.max()), 88, 88, 1))
    for i, k in enumerate(vf):
        video[i, :k] = torch.from_numpy(rng.random((k, 88, 88, 1)))
    u = (secs * 4).astype(np.int64) + 1
    labels = torch.zeros((n, int(u.max())), dtype=torch.int64)
    for i, k in enumerate(u):
        labels[i, :k] = torch.from_numpy(rng.integers(1, 32, k))
    alen, vlen = torch.from_numpy(ns), torch.from_numpy(vf)
    inputs = [video, vlen, audio, alen] if kind == "av" else [audio, alen]
    return inputs, labels, torch.from_numpy(u)


@pytest.fixture(scope="module", params=["av", "ao"])
def built(request):
    kind = request.param
    torch.manual_seed(0)
    model, state = avec.build_model(SPECS[kind], ROUTE, 5, torch.device("cpu"))
    names = {n for n, _ in model.named_parameters()}
    P = {k: v.clone() for k, v in state.items() if k in names}
    B = {k: v.clone() for k, v in state.items() if k not in names}
    return kind, model, P, B


@pytest.mark.parametrize("route", ["train", "serve"])
def test_eval_logits_match(built, route):
    kind, model, P, B = built
    if route == "serve":
        model, _ = avec.build_model(SPECS[kind], SERVE, 5,
                                    torch.device("cpu"))
    inputs, _, _ = _batch(kind, 1)
    model.eval()
    with torch.no_grad():
        got, got_len = model(*inputs)["outputs"]
    want, want_len = ref_train.eval_logits(avec.reference_forward,
                                           SPECS[kind], P, B, inputs)
    assert torch.equal(got_len, want_len)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 1e-5 * scale


def test_train_step_losses_and_gradients_match(built):
    kind, model, P, B = built
    tr = avec.trainer(model, {"precision": "float32",
                              "loss_weights": TRAIN["loss_weights"]},
                      1234, torch.device("cpu"))
    model.load_state_dict({**P, **B})
    inputs, labels, u = _batch(kind, 2)
    losses, _ = tr.train_step({"inputs": inputs, "targets": (labels, u)},
                              accumulated_steps=2)
    opt = tr.optimizer.optimizer
    got_g = {n: (opt.state[p]["exp_avg"] / 0.1).norm().item()
             for n, p in model.named_parameters()}
    want = ref_train.train_readings(
        avec.reference_forward, SPECS[kind], TRAIN, P,
        [{"inputs": inputs, "labels": labels, "label_len": u}], 1234)
    for key, value in want["losses"][0].items():
        k = "loss" if key == "loss" else "loss_" + key
        assert abs(float(losses[k]) - value) < 1e-5 * abs(value), key
    gm = float(np.median(list(want["grad_norm"].values())))
    worst = max(abs(got_g[k] - v) / max(v, gm)
                for k, v in want["grad_norm"].items())
    assert worst < 1e-2


def test_control_in_float8_departs(built):
    kind, _, P, B = built
    inputs, _, _ = _batch(kind, 3)
    forward = avec.reference_forward
    want, _ = ref_train.eval_logits(forward, SPECS[kind], P, B, inputs)
    low, _ = ref_train.eval_logits(forward, SPECS[kind], P, B, inputs,
                                   fp8=True)
    rel = (low - want).abs().max().item() / want.abs().max().item()
    assert rel > 1e-3


def test_hash_mask_is_the_rule_of_the_fused_kernels():
    from avec_tpu_torch.ops.ffn import dropout_mask

    for tile in (256, 37):
        got = dropout_mask(99, 300, 48, 2, 0.9, tile_rows=tile)
        want = ref.hash_keep(99, 300, 48, 2, tile, "cpu")
        assert torch.equal(got, want)


def test_weights_are_seeded():
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "n.weight": (4,),
              "n.running_mean": (4,), "n.running_var": (4,)}
    a = weights.make_state(shapes, 3, "cpu")
    b = weights.make_state(shapes, 3, "cpu")
    c = weights.make_state(shapes, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert torch.equal(a["n.weight"], torch.ones(4))
