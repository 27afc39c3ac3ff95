"""The port's decoding and GPT on the card: the device beam search against
the native decoder, and GPT-Small's fp32 forward against the CPU's.

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_cuda.py -m cuda -q

Every test is marked `cuda` and skips without a card. Tolerances: beam
scores 1e-3 with equal best prefixes, and equal prefixes where no two
scores tie (the device search in fp32, the native one in fp64 on fp32
log-probs); GPT-Small's logits 1e-4 of the largest, TF32 off.
"""

import math

import numpy as np
import pytest
import torch

from avec_tpu_torch.decode.device_beam import (DeviceNgramTables,
                                               device_beam_search,
                                               search_on_device)
from avec_tpu_torch.decode.native import NativeBeamDecoder
from avec_tpu_torch.decode.ngram import ArpaLM, estimate_arpa
from avec_tpu_torch.models.zoo import GPT

from test_torch_kernels import cuda_device  # noqa: F401

torch.set_num_threads(1)


def _agree(got, want, tol=1e-3):
    assert got[0][0] == want[0][0]
    n = min(len(got), len(want))
    for k in range(n):
        (pa, sa), (pb, sb) = got[k], want[k]
        if not math.isfinite(sb):
            assert sa == sb
            continue
        assert abs(sa - sb) < tol, (k, sa, sb)
        if all(abs(sb - s) > 1e-3 for j, (_, s) in enumerate(want[:n])
               if j != k):
            assert pa == pb, k


@pytest.mark.cuda
@pytest.mark.parametrize("order, cutoff", [(None, None), (6, None), (6, 32)])
def test_device_beam_matches_native_on_the_card(cuda_device, tmp_path, order,
                                                cutoff):
    """B=4 utterances of ragged lengths, V 256, beam 16, T 101 (the served
    AV model's frames in the 8 s bucket), an order-6 ARPA over seeded
    transcripts."""
    rng = np.random.RandomState(0)
    tables, kw = None, {}
    if order:
        seqs = [[chr(100 + int(t)) for t in rng.randint(1, 256,
                                                        rng.randint(4, 30))]
                for _ in range(1500)]
        path = estimate_arpa(seqs, str(tmp_path / "lm.arpa"), order=order)
        tables = DeviceNgramTables(ArpaLM(path), 100, device=cuda_device)
        kw = dict(ngram_path=path, ngram_offset=100)
    logits = rng.randn(4, 101, 256).astype(np.float32) * 3
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    logp = logp.astype(np.float32)
    lens = np.array([101, 77, 40, 1], np.int32)
    got = device_beam_search(torch.from_numpy(logp).to(cuda_device),
                             torch.from_numpy(lens), beam_size=16,
                             tables=tables, alpha=0.6, beta=1.0,
                             cutoff_top_n=cutoff)
    native = NativeBeamDecoder(beam_size=16, alpha=0.6, beta=1.0,
                               cutoff_top_n=cutoff, num_threads=4, **kw)
    for g, w in zip(got, native.decode_batch(logp, lens)):
        _agree(g, w)


@pytest.mark.cuda
def test_device_frame_loop_never_waits_for_the_card(cuda_device, tmp_path):
    """The search's frame loop (order-6 n-gram lookups, cutoff, merges)
    runs under torch's sync debug mode "error": no call in it copies to the
    host or waits for the device."""
    rng = np.random.RandomState(2)
    seqs = [[chr(100 + int(t)) for t in rng.randint(1, 64, rng.randint(4, 20))]
            for _ in range(300)]
    path = estimate_arpa(seqs, str(tmp_path / "lm.arpa"), order=6)
    tables = DeviceNgramTables(ArpaLM(path), 100, device=cuda_device)
    logp = torch.log_softmax(torch.randn(3, 40, 64, device=cuda_device) * 3,
                             dim=-1)
    lens = torch.tensor([40, 21, 1], device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tokens, lengths, scores = search_on_device(
            logp, lens, 8, 0, tables, 0.6, 1.0, 16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tokens.shape == (3, 8, 40) and lengths.shape == scores.shape
    assert bool(torch.isfinite(scores[:, 0]).all())


@pytest.mark.cuda
def test_gpt_small_forward_matches_the_cpu(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=1025, padding_idx=0, max_pos_encoding=2048,
               model="GPT-Small", pos_embedding="learned")
    gpu = GPT(device=cuda_device, **cfg)
    cpu = GPT(device="cpu", **cfg)
    cpu.load_state_dict(gpu.state_dict())
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 1025, (4, 48)))
    with torch.no_grad():
        got = gpu(ids.to(cuda_device))["output"].cpu()
        want = cpu(ids)["output"]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
