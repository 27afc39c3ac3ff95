"""The port's serving slice vs the JAX package, and the weight round trip.

The port's Server runs the AV model with use_flash=True and stem "pallas"
(their plain versions on the CPU); the JAX model runs its eval `apply_net`
with use_flash=False and stem "2d" (its Pallas paths run on the CPU only in
interpret mode). Depths are those of configs/Synthetic/AV-Tone.py:72-75
(vocab 32), B=2 requests of 1-2 s, fp32. Logits agree to 2e-3 and the
greedy token ids are identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avec_tpu.models import zoo as jzoo
from avec_tpu.ops.ctc import ctc_greedy_collapse as jax_collapse
from avec_tpu.train import checkpoint as jckpt
from avec_tpu.train.torch_convert import convert_state_dict
from avec_tpu_torch.convert import params_from_jax
from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC
from avec_tpu_torch.serve import Server, _bucket

from test_torch_support import random_variables

torch.set_num_threads(1)

AV_TONE = dict(vocab_size=32, v_num_blocks=[2, 1], a_num_blocks=[2, 2, 1],
               f_num_blocks=2, v_interctc_blocks=[2], a_interctc_blocks=[2, 4],
               f_interctc_blocks=[1])


def _request(rng, seconds):
    """Tones that change pitch and loudness every 0.12 s, and frames of
    varying brightness: inputs that vary over time give the random-weight
    model more than one greedy token."""
    n, seg = int(16000 * seconds), 1920
    freq = np.repeat(rng.uniform(100, 4000, n // seg + 1), seg)[:n]
    amp = np.repeat(rng.uniform(0.0, 0.5, n // seg + 1), seg)[:n]
    frames = n // 640 + 1
    return {"audio": (amp * np.sin(2 * np.pi * np.cumsum(freq) / 16000))
            .astype(np.float32),
            "video": (rng.rand(frames, 88, 88, 1) * rng.rand(frames, 1, 1, 1)
                      * 2).astype(np.float32)}


@pytest.fixture(scope="module")
def av():
    """JAX model + seeded variables, and the port model carrying them."""
    jmodel = jzoo.AudioVisualEfficientConformerInterCTC(use_flash=False,
                                                        **AV_TONE)
    al = 16000
    args = (np.zeros((1, al // 640 + 1, 88, 88, 1), np.float32),
            np.array([al // 640 + 1], np.int32), np.zeros((1, al), np.float32),
            np.array([al], np.int32))
    shapes = jax.eval_shape(lambda: jmodel.net.init(
        {"params": jax.random.PRNGKey(0)}, *args, training=False))
    params, stats = random_variables(shapes, seed=0)
    port = AudioVisualEfficientConformerInterCTC(
        use_flash=True, stem_mode="pallas", device="cpu", **AV_TONE)
    port.load_state_dict(params_from_jax(params, stats), strict=True)
    rng = np.random.RandomState(1)
    reqs = [_request(rng, 1.0), _request(rng, 1.7)]
    return jmodel, params, stats, port, reqs


def test_serving_slice_matches_jax(av):
    jmodel, params, stats, port, reqs = av
    srv = Server(model=port, device="cpu", precision="float32")
    inputs = srv._inputs_for_batch(reqs, _bucket(27200), 2)
    out, _ = jmodel.apply_net(params, stats, inputs, False)
    want_logits, want_len = out["outputs"]
    got_logits, got_len = srv.forward(inputs)
    assert got_logits.shape == want_logits.shape == (2, 26, 32)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=2e-3)

    toks, tok_len = jax_collapse(jnp.argmax(want_logits, -1), want_len)
    want_ids = [np.asarray(toks)[b, :int(tok_len[b])].tolist()
                for b in range(2)]
    results = srv.transcribe_batch(reqs)
    assert [r["tokens"] for r in results] == want_ids
    assert all(r["rtf"] > 0 and r["batch_size"] == 2 for r in results)
    s = srv.stats_summary()
    assert s["requests"] == 2 and s["latency_p95_s"] >= s["latency_p50_s"] > 0


def test_serving_padding_invariance(av):
    """Bucket padding and batch padding (3 requests -> batch bucket 4, with a
    pad row) do not change any request's token ids."""
    _, _, _, port, reqs = av
    srv = Server(model=port, device="cpu", precision="float32")
    singles = [srv.transcribe_batch([r])[0]["tokens"] for r in reqs]
    batched = srv.transcribe_batch(reqs + [reqs[0]])
    assert [r["tokens"] for r in batched] == singles + singles[:1]
    req = reqs[0]
    small = srv._inputs_for_batch([req], _bucket(16000), 1)
    large = srv._inputs_for_batch([req], _bucket(16000) * 2, 1)
    ids = []
    for inputs in (small, large):
        pre = srv.decoder.device_fn(srv.forward(inputs))
        ids.append(srv.decoder(pre)[0])
    assert ids[0] == ids[1] == singles[0]


def test_weights_round_trip(av):
    """JAX variables -> params_from_jax -> the JAX package's own converter
    gives back the JAX tree exactly."""
    _, params, stats, port, _ = av
    template = jckpt.state_dict_flatten({"params": params,
                                         "batch_stats": stats})
    back, report = convert_state_dict(port.state_dict(), template)
    assert not report["dropped"]
    assert back.keys() == template.keys()
    for key, want in template.items():
        np.testing.assert_array_equal(back[key], np.asarray(want), err_msg=key)
