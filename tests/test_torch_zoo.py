"""The port's zoo models vs the JAX package: the audio-only model (patch and
regular attention, eval and a train step), the video-only model with
test-time augmentation, the LRW classifier (logits, cross-entropy,
accuracy), the serving modes, the mapping of list specs onto the output
names, the launch counts, the LRW front end's partial load, the data and
the weight conversion.

Sizes are small: AO blocks (1, 1, 1), VO and LRW blocks (1, 1), vocab 16 (LRW
20), B = 2, fp32 on the CPU, weights drawn with numpy for the JAX variables'
shapes (`tests/test_torch_support.py`). The JAX VO and LRW nets build their
encoder at the reference depth (6, 6); for the duration of a test the
encoder class their module looks up is given num_blocks (1, 1) (their own
code runs; nothing in `avec_tpu/` changes). Tolerances: logits 2e-3 with
identical greedy ids or classes, losses and accuracy 1e-4 relative; the
train step as `tests/test_torch_train_step*.py` holds it (losses 1e-4
relative, every gradient leaf 2e-3 of its largest entry plus 1e-7, updated
BN statistics 1e-5), the port's fused attention, convolution and FFN
modules through their plain versions against the JAX step with its Pallas
kernels in interpret mode.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.data import synthetic as jsynth
from avec_tpu.data.collate import CollateFn as JaxCollateFn
from avec_tpu.models import encoders as jenc
from avec_tpu.models import zoo as jzoo
from avec_tpu.ops.ctc import ctc_greedy_collapse as jax_collapse
from avec_tpu.train import checkpoint as jckpt
from avec_tpu.train import losses as jlosses
from avec_tpu.train import metrics as jmetrics
from avec_tpu.train.model import _format_outputs
from avec_tpu.train.torch_convert import convert_state_dict
from avec_tpu_torch.convert import (grads_to_jax_layout, params_from_jax,
                                    state_to_jax)
from avec_tpu_torch.data import synthetic
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.models import zoo
from avec_tpu_torch.ops.batch_norm import launches as bn_launches
from avec_tpu_torch.serve import Server, _batch_bucket, _bucket
from avec_tpu_torch.train.losses import CTCLoss, SoftmaxCrossEntropy
from avec_tpu_torch.train.metrics import CategoricalAccuracy
from avec_tpu_torch.train.model import Trainer, _by_output

from test_torch_serve import _request
from test_torch_support import REPO, random_variables, t
from test_torch_train_step import _leaves, no_jax_noise  # noqa: F401
from test_torch_train_step_conv import jax_fused_conv  # noqa: F401
from test_torch_train_step_fused import jax_fused  # noqa: F401

torch.set_num_threads(1)

AO = dict(vocab_size=16, num_blocks=(1, 1, 1), interctc_blocks=(1, 2))
SMALL_VIDEO = (1, 1)
CONV_KERNELS = ("fused_conv_stats", "fused_conv_fwd", "fused_conv_bwd1",
                "fused_conv_bwd2")


def _jit_eval(jmodel):
    return jax.jit(lambda p, s, *a: jmodel.apply_net(p, s, list(a), False)[0])


def _variables(jmodel, args, seed=0):
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    return random_variables(shapes, seed=seed)


def _greedy_ids(logits, lengths):
    toks, tok_len = jax_collapse(jnp.argmax(jnp.asarray(logits), -1),
                                 jnp.asarray(lengths))
    return [np.asarray(toks)[b, :int(tok_len[b])].tolist()
            for b in range(len(tok_len))]


def _audio_batch(lens=(27200, 16000), seed=3):
    rng = np.random.RandomState(seed)
    alen = np.asarray(lens, np.int32)
    audio = (rng.randn(len(alen), int(alen.max())) * 0.1).astype(np.float32)
    labels = rng.randint(1, 16, size=(len(alen), 5)).astype(np.int32)
    return {"inputs": [audio, alen],
            "targets": (labels, np.array([5, 3], np.int32))}


@pytest.fixture(scope="module", params=["patch", "regular"])
def ao(request):
    jmodel = jzoo.AudioEfficientConformerInterCTC(att_type=request.param,
                                                  **AO)
    params, stats = _variables(jmodel, (np.zeros((1, 16000), np.float32),
                                        np.array([16000], np.int32)))
    return request.param, jmodel, params, stats


def _port_ao(att_type, params, stats, **route):
    model = zoo.AudioEfficientConformerInterCTC(
        device="cpu", att_type=att_type, **AO, **route)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    return model


def test_ao_eval_matches_jax(ao):
    """Patch attention in stage 1 (att_type "patch") or regular attention in
    every stage, the regular layers on the port's flash route (its plain
    version here): logits and InterCTC logits 2e-3, identical greedy
    ids."""
    att_type, jmodel, params, stats = ao
    inputs = _audio_batch()["inputs"]
    out = _jit_eval(jmodel)(params, stats, *inputs)
    port = _port_ao(att_type, params, stats, use_flash=True)
    n_flash = 2 if att_type == "patch" else 3
    assert port.kernel_launches_per_step() == {
        "flash_attention_fwd": n_flash, "flash_attention_bwd_dq": n_flash,
        "flash_attention_bwd_dkv": n_flash, **bn_launches(4)}
    got = port(*(t(a) for a in inputs))
    assert set(got) == set(out) == {"outputs", "ctc_0", "ctc_1"}
    for key in got:
        np.testing.assert_array_equal(got[key][1].numpy(),
                                      np.asarray(out[key][1]))
        np.testing.assert_allclose(got[key][0].numpy(),
                                   np.asarray(out[key][0]), rtol=0, atol=2e-3)
    assert (_greedy_ids(got["outputs"][0].numpy(), got["outputs"][1])
            == _greedy_ids(*out["outputs"]))


@pytest.mark.parametrize("ao", ["patch"], indirect=True)
def test_list_specs_map_onto_sorted_output_names(ao):
    """The JAX engine maps a list of losses, loss weights, metrics or
    decoders onto the output names in the order `jax.eval_shape` returns
    them, sorted; the port's model returns "outputs" first. The port maps a
    list as the JAX package does, and AO-Tone's [0.25, 0.25, 0.5] puts 0.5
    on "outputs" in both packages, in the trainer's total loss too."""
    att_type, jmodel, params, stats = ao
    batch = _audio_batch()
    args = tuple(jnp.asarray(a) for a in batch["inputs"])
    names = list(_format_outputs(jax.eval_shape(
        lambda v, a: jmodel.net.apply(v, *a, training=False),
        {"params": params, "batch_stats": stats}, args)))
    assert names == ["ctc_0", "ctc_1", "outputs"]
    port = _port_ao(att_type, params, stats)
    outputs = port(*(t(a) for a in batch["inputs"]))
    assert list(outputs)[0] == "outputs"
    proto = {k: None for k in names}
    a, b, c = object(), object(), object()
    for struct in ([a, b, c], [0.25, 0.25, 0.5], [a, None, b], [a], a,
                   {"outputs": a}, None):
        want = jmodel.map_to_outputs(proto, struct) or {}
        assert _by_output(struct, outputs) == {
            k: v for k, v in want.items() if v is not None}, struct

    jmodel.compile(loss_weights=[0.25, 0.25, 0.5])
    jw = jmodel.map_to_outputs(proto, jmodel.compiled_loss_weights)
    assert jw["outputs"](1) == 0.5 and jw["ctc_0"](1) == 0.25
    trainer = Trainer(model=port, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True),
                      loss_weights=[0.25, 0.25, 0.5])
    with torch.no_grad():
        port.eval()
        out = port(*(t(a) for a in batch["inputs"]))
        losses = trainer.compute_losses(out, _torch(batch["targets"]), 0)
    want_total = (0.25 * losses["loss_ctc_0"] + 0.25 * losses["loss_ctc_1"]
                  + 0.5 * losses["loss_outputs"])
    assert float(losses["loss"]) == pytest.approx(float(want_total),
                                                  rel=1e-6)
    # the model's own compile defaults: (0.5/4,) * 4 + (0.5,) as a list
    dflt = Trainer(model=port, device="cpu", precision="float32")
    jmodel.compile()
    jd = jmodel.map_to_outputs(proto, jmodel.compiled_loss_weights)
    got_d = _by_output(dflt.loss_weights, out)
    assert {k: w(1) for k, w in got_d.items()} == {
        k: w(1) for k, w in jd.items() if w is not None}


def _torch(struct):
    return tuple(t(a) for a in struct)


@pytest.mark.parametrize("ao", ["patch"], indirect=True)
def test_ao_train_step_matches_jax(ao, no_jax_noise, jax_fused_conv):
    """One forward + backward on a ragged batch through the fused FFN,
    attention (stages 2-3; patch attention and the flash layers stay
    unfused) and convolution modules, plain versions, against the JAX step
    through its Pallas kernels in interpret mode, the AO-Tone loss weights
    mapped onto the sorted names in both packages."""
    att_type, jmodel, params, stats = ao
    batch = _audio_batch()
    names = ["ctc_0", "ctc_1", "outputs"]
    jmodel.compile(losses=jlosses.CTCLoss(zero_infinity=True,
                                          assert_shorter=False),
                   loss_weights=[0.25, 0.25, 0.5])
    proto = {k: None for k in names}
    jmodel.output_names = names
    jmodel.losses = jmodel.map_to_outputs(proto, jmodel.compiled_losses)
    jmodel.loss_weights = jmodel.map_to_outputs(proto,
                                                jmodel.compiled_loss_weights)
    targets = jmodel._map_targets(tuple(jnp.asarray(a)
                                        for a in batch["targets"]))
    rngs = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}

    def loss_fn(p):
        outputs, new_bs, _, _ = jmodel.apply_net(p, stats, batch["inputs"],
                                                 True, rngs, with_aux=True)
        losses = jmodel._compute_losses(outputs, targets, 0)
        return losses["loss"], (losses, new_bs)

    want_grads, (want_losses, want_bs) = jax.jit(
        jax.grad(loss_fn, has_aux=True))(params)
    model = _port_ao(att_type, params, stats, fused_att=True,
                     fused_conv=True, fused_ffn=True)
    n_att = 2 if att_type == "patch" else 3
    assert model.kernel_launches_per_step() == {
        "fused_ffn_fwd": 6, "fused_ffn_bwd": 6, "fused_att_fwd": n_att,
        "fused_att_bwd": n_att, **{k: 1 for k in CONV_KERNELS},
        **bn_launches(3)}
    trainer = Trainer(model=model, device="cpu", precision="float32",
                      loss=CTCLoss(zero_infinity=True),
                      loss_weights=[0.25, 0.25, 0.5])
    trainer.model.set_regularization(False)
    losses, grads = trainer.loss_and_grads(batch)
    assert set(losses) == set(want_losses)
    for k, w in want_losses.items():
        assert float(losses[k]) == pytest.approx(float(w), rel=1e-4), k
    got = dict(_leaves(grads_to_jax_layout(grads, params)))
    want = dict(_leaves(want_grads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 2e-3 * np.abs(w).max() + 1e-7, (k, err)
    _, got_bs = state_to_jax(trainer.model.state_dict(), params, stats)
    for (k, g), (k2, w) in zip(_leaves(got_bs), _leaves(want_bs)):
        assert k == k2
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture
def small_jax_video(monkeypatch):
    """The JAX VO and LRW nets build their encoder at num_blocks (1, 1)."""
    monkeypatch.setattr(jzoo, "VisualEfficientConformerEncoder",
                        functools.partial(jenc.VisualEfficientConformerEncoder,
                                          num_blocks=SMALL_VIDEO))


def _video(b=2, frames=5, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, frames, 88, 88, 1) * rng.rand(b, frames, 1, 1, 1)
            * 2).astype(np.float32)


def test_vo_eval_with_test_augments_matches_jax(small_jax_video):
    """The VO model with the VO config's flip as test-time augmentation:
    logits and lengths (B, 2, T, V) and (B, 2) as the JAX net stacks them,
    the InterCTC outputs of the base forward, 2e-3; without augments the
    forward is the base forward alone."""
    video, vlen = _video(), np.array([5, 3], np.int32)
    jmodel = jzoo.VisualEfficientConformerInterCTC(
        vocab_size=16, interctc_blocks=(1,),
        test_augments=[lambda v: jnp.flip(v, axis=3)])
    params, stats = _variables(jmodel, (video[:1], vlen[:1]))
    out = _jit_eval(jmodel)(params, stats, video, vlen)
    port = zoo.VisualEfficientConformerInterCTC(
        vocab_size=16, interctc_blocks=(1,), num_blocks=SMALL_VIDEO,
        test_augments=[zoo.hflip], stem_mode="pallas", device="cpu")
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    got = port(t(video), t(vlen))
    assert got["outputs"][0].shape == (2, 2, 3, 16)
    assert set(got) == set(out) == {"outputs", "ctc_0"}
    for key in got:
        np.testing.assert_array_equal(got[key][1].numpy(),
                                      np.asarray(out[key][1]))
        np.testing.assert_allclose(got[key][0].numpy(),
                                   np.asarray(out[key][0]), rtol=0, atol=2e-3)
    port.test_augments = []
    base = port(t(video), t(vlen))["outputs"][0]
    assert torch.equal(base, got["outputs"][0][:, 0])
    assert not torch.allclose(base, got["outputs"][0][:, 1])


@pytest.fixture
def lrw(small_jax_video):
    video = _video(frames=4, seed=11)
    jmodel = jzoo.VisualEfficientConformerCE(vocab_size=20)
    params, stats = _variables(jmodel, (video[:1],))
    port = zoo.VisualEfficientConformerCE(vocab_size=20,
                                          num_blocks=SMALL_VIDEO,
                                          stem_mode="pallas", device="cpu")
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    return jmodel, params, stats, port, video


def test_lrw_logits_loss_and_accuracy_match_jax(lrw):
    """Logits averaged over every frame (2e-3, the same classes), softmax
    cross-entropy with an ignored target (the mean over every element) and
    accuracy (1e-4), directly and through the trainer's `evaluate` with the
    model's compile defaults."""
    jmodel, params, stats, port, video = lrw
    want = np.asarray(_jit_eval(jmodel)(params, stats, video)["output"])
    got = port(t(video))["output"]
    assert got.shape == want.shape == (2, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()
    labels = np.array([want[0].argmax(), (want[1].argmax() + 1) % 20],
                      np.int32)
    for y in (labels, np.array([-1, labels[1]], np.int32)):
        jl = float(jlosses.SoftmaxCrossEntropy()(jnp.asarray(y),
                                                 jnp.asarray(want)))
        assert float(SoftmaxCrossEntropy()(t(y), got)) == pytest.approx(
            jl, rel=1e-4)
        ja = float(jmetrics.CategoricalAccuracy()(jnp.asarray(y),
                                                  jnp.asarray(want)))
        assert float(CategoricalAccuracy()(t(y), got)) == pytest.approx(ja)
    trainer = Trainer(model=port, device="cpu", precision="float32")
    assert isinstance(trainer.loss, SoftmaxCrossEntropy)
    losses, metrics = trainer.evaluate([{"inputs": video,
                                         "targets": labels}])
    assert losses["loss"] == pytest.approx(float(jlosses.SoftmaxCrossEntropy()(
        jnp.asarray(labels), jnp.asarray(want))), rel=1e-4)
    assert metrics == {"acc": pytest.approx(50.0)}


def test_lrw_front_end_partial_load_into_vo(lrw, tmp_path):
    """A train step of the LRW classifier (cross-entropy on the labels),
    its checkpoint, and the VO config's partial load: the `front_end`
    entries of the checkpoint go into a VO model, non-strict; nothing else
    of the VO model changes."""
    _, _, _, port, video = lrw
    trainer = Trainer(model=port, device="cpu", precision="float32")
    losses, infos = trainer.train_step({"inputs": video,
                                        "targets": np.array([3, 7],
                                                            np.int32)})
    assert np.isfinite(float(losses["loss"]))
    path = str(tmp_path / "lrw.ckpt")
    trainer.save(path)
    vo = zoo.VisualEfficientConformerInterCTC(
        vocab_size=16, interctc_blocks=(1,), num_blocks=SMALL_VIDEO,
        device="cpu", generator=torch.Generator().manual_seed(5))
    before = {k: v.clone() for k, v in vo.state_dict().items()}
    vo_trainer = Trainer(model=vo, device="cpu", precision="float32")
    vo_trainer.load(path, select=lambda k: "front_end" in k)
    lrw_state = port.state_dict()
    front = [k for k in before if "front_end" in k]
    assert front and len(front) == sum("front_end" in k for k in lrw_state)
    for k, v in vo.state_dict().items():
        assert torch.equal(v, lrw_state[k] if k in front else before[k]), k
    with pytest.raises(KeyError):
        vo_trainer.load(path, select=lambda k: False)
    os.remove(path)


@pytest.mark.parametrize("ao", ["patch"], indirect=True)
def test_serving_modes_match_jax_serve(ao):
    """Server(mode="ao") feeds the audio alone and Server(mode="vo") the
    video alone, padded into the batch of tools/serve.py's same mode; the
    AO server's token ids are the JAX model's greedy ids on that batch."""
    sys.path.insert(0, str(REPO / "tools"))
    import serve as jserve

    att_type, jmodel, params, stats = ao
    rng = np.random.RandomState(2)
    reqs = [_request(rng, 1.0), _request(rng, 1.7), _request(rng, 0.6)]
    port = _port_ao(att_type, params, stats)
    for mode, model in (("ao", port), ("vo", None)):
        rq = [{k: r[k] for k in (("audio",) if mode == "ao" else ("video",))}
              for r in reqs]
        jsrv = jserve.Server(mode=mode, tokenizer=str(REPO / "missing.json"))
        srv = Server(model=model, mode=mode, device="cpu",
                     precision="float32", vocab_size=16,
                     num_blocks=SMALL_VIDEO, interctc_blocks=(1,))
        n = max(srv._request_samples(r) for r in rq)
        assert n == max(jsrv._request_samples(r) for r in rq)
        assert _bucket(n) == jserve._bucket(n) and _batch_bucket(3) == 4
        got = srv._inputs_for_batch(rq, _bucket(n), 4)
        want = jsrv._inputs_for_batch(rq, _bucket(n), 4)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if mode == "ao":
            out = _jit_eval(jmodel)(params, stats, *got)
            ids = [r["tokens"] for r in srv.transcribe_batch(rq)]
            assert ids == _greedy_ids(*out["outputs"])[:3]
    ao_server = Server(mode="ao", device="cpu", vocab_size=8,
                       num_blocks=(1, 1, 1))
    assert ao_server.model.encoder.back_end.interctc_at == []


def test_launch_counts_at_reference_depth():
    """kernel_launches_per_step from each model's own tree at the reference
    depth: the flash kernels only in RelPos1d layers with use_flash, the
    fused attention module only in non-causal RelPos1d layers (not patch,
    not Transformer-XL), the conv kernels in every stride-1 block (pad_lo
    14 in the causal model), the stem kernel once for the "pallas" stem, the
    BatchNorm kernels for the audio stem's BatchNorm, the strided blocks'
    (2 in audio, 1 in video) and the ResNet trunk's 19."""
    route = dict(fused_ffn=True, fused_att=True, fused_conv=True,
                 device="cpu")
    conv = {k: 14 for k in CONV_KERNELS}
    ao_flash = zoo.AudioEfficientConformerInterCTC(use_flash=True, **route)
    assert ao_flash.kernel_launches_per_step() == {
        "fused_ffn_fwd": 32, "fused_ffn_bwd": 32, "flash_attention_fwd": 11,
        "flash_attention_bwd_dq": 11, "flash_attention_bwd_dkv": 11, **conv,
        **bn_launches(3)}
    ao_fused = zoo.AudioEfficientConformerInterCTC(**route)
    assert ao_fused.kernel_launches_per_step() == {
        "fused_ffn_fwd": 32, "fused_ffn_bwd": 32, "fused_att_fwd": 11,
        "fused_att_bwd": 11, **conv, **bn_launches(3)}
    causal = zoo.AudioEfficientConformerInterCTC(causal=True, left_context=64,
                                                 use_flash=True, **route)
    assert causal.kernel_launches_per_step() == {
        "fused_ffn_fwd": 32, "fused_ffn_bwd": 32, **conv, **bn_launches(3)}
    pads = {m.padding for m in causal.modules()
            if hasattr(m, "fused_conv") and m.fused_eligible()}
    assert pads == {"causal"}
    video = {"fused_ffn_fwd": 24, "fused_ffn_bwd": 24, "fused_att_fwd": 12,
             "fused_att_bwd": 12, "bn_relu_pool": 1,
             **{k: 11 for k in CONV_KERNELS}, **bn_launches(20, 1)}
    for cls in (zoo.VisualEfficientConformerInterCTC,
                zoo.VisualEfficientConformerCE):
        assert cls(stem_mode="pallas", **route).kernel_launches_per_step() \
            == video


def test_tone_and_classification_data_match_jax():
    """The port's ToneSpeechDataset (AO-Tone) and SyntheticClassification
    Dataset (LRW, with the LRW config's collate) give the JAX package's
    samples and batches."""
    for cls, kw in ((("ToneSpeechDataset"), dict(num_samples=6, vocab_size=32,
                                                 seed=10_000_000,
                                                 batch_size=3)),
                    ("SyntheticClassificationDataset",
                     dict(num_samples=4, num_classes=500, seed=123))):
        mine = getattr(synthetic, cls)(**kw)
        theirs = getattr(jsynth, cls)(**kw)
        assert len(mine) == len(theirs)
        for i in range(len(mine)):
            for a, b in zip(mine[i], theirs[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    samples = [synthetic.SyntheticClassificationDataset(seed=123)[i]
               for i in range(3)]
    spec = dict(inputs_params=[{"axis": 0}], targets_params=[{"axis": 1}])
    got, want = CollateFn(**spec)(samples), JaxCollateFn(**spec)(samples)
    for k in ("inputs", "targets"):
        np.testing.assert_array_equal(got[k], want[k])
    tone = synthetic.ToneSpeechDataset(num_samples=3, seed=0)
    jtone = jsynth.ToneSpeechDataset(num_samples=3, seed=0)
    got = tone.collate_fn([tone[i] for i in range(3)])
    want = jtone.collate_fn([jtone[i] for i in range(3)])
    for g, w in zip(got["inputs"] + list(got["targets"]),
                    want["inputs"] + list(want["targets"])):
        np.testing.assert_array_equal(g, w)


def test_weight_conversion_of_the_new_trees(small_jax_video):
    """params_from_jax and state_to_jax over the causal AO (with the
    Transformer-XL u and v), VO and LRW trees give back the JAX trees; the
    JAX package's own converter has no rule for u and v, so its
    `Model.load` cannot read a causal checkpoint of the port (a limit of
    the JAX converter, not of the port)."""
    jcausal = jzoo.AudioEfficientConformerInterCTC(causal=True,
                                                   left_context=8, **AO)
    audio = (np.zeros((1, 16000), np.float32), np.array([16000], np.int32))
    jvo = jzoo.VisualEfficientConformerInterCTC(vocab_size=16,
                                                interctc_blocks=(1,))
    video = (_video(b=1, frames=3), np.array([3], np.int32))
    jlrw = jzoo.VisualEfficientConformerCE(vocab_size=20)
    for jmodel, args in ((jcausal, audio), (jvo, video), (jlrw, video[:1])):
        params, stats = _variables(jmodel, args, seed=2)
        sd = params_from_jax(params, stats)
        back_p, back_s = state_to_jax(sd, params, stats)
        for (k, g), (k2, w) in zip(_leaves({**back_p, **back_s}),
                                   _leaves({**params, **stats})):
            assert k == k2
            np.testing.assert_array_equal(g, w, err_msg=k)
        template = jckpt.state_dict_flatten({"params": params,
                                             "batch_stats": stats})
        if jmodel is jcausal:
            assert any(k.endswith(".u") for k in sd)
            with pytest.raises(KeyError):
                convert_state_dict(sd, template)
        else:
            back, report = convert_state_dict(sd, template)
            assert not report["dropped"] and back.keys() == template.keys()


def test_new_entry_points_default_to_cuda(tmp_path):
    """The new models, serving modes and configs run on the card unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from avec_tpu_torch.configs import ao_tone, ao_tone_causal, lrw as lrw_cfg

    for make in (lambda: zoo.AudioEfficientConformerInterCTC(**AO),
                 lambda: zoo.VisualEfficientConformerInterCTC(vocab_size=8),
                 lambda: zoo.VisualEfficientConformerCE(vocab_size=8),
                 lambda: Server(mode="ao", vocab_size=8),
                 lambda: Server(mode="vo", vocab_size=8),
                 lambda: ao_tone.build(str(tmp_path / "ao")),
                 lambda: ao_tone_causal.build(str(tmp_path / "aoc")),
                 lambda: lrw_cfg.build(str(tmp_path / "lrw"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(ValueError, match="mode"):
        Server(mode="audio", device="cpu")


def test_new_modules_import_no_jax():
    """The new modules pull in neither jax nor avec_tpu (a fresh
    interpreter: this test process already imported JAX)."""
    import subprocess

    code = ("import sys, avec_tpu_torch.ops.pos_embeddings, "
            "avec_tpu_torch.configs.ao_tone, "
            "avec_tpu_torch.configs.ao_tone_causal, "
            "avec_tpu_torch.configs.lrw, avec_tpu_torch.models.zoo\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'avec_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
