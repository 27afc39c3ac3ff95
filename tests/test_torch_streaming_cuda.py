"""The port's streaming and file serving on the card: the causal
transcriber's exactness in fp32, the Transformer-XL key/value cache on the
card against the CPU, and a batch served from wav and flac files through
the flash kernel (K4).

This file imports neither JAX nor the JAX package. On a machine with an
NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_streaming_cuda.py -m cuda -q

Every test is marked `cuda` and skips without a card. TF32 is off. The
causal model: the AO widths (180, 256, 360) at blocks (2, 2, 1), vocab 256,
left context 64; its chunked logits within 2e-4 of its offline causal
forward with identical tokens. The attention: 1e-4 of the CPU's. The
served batch: K4 launched once per flash layer per forward, fp32 token ids
equal to those of the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from avec_tpu_torch.decode.causal_streaming import (CausalStreamingTranscriber,
                                                    _od)
from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
from avec_tpu_torch.decode.streaming import _collapse_host
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       randomize_batch_stats)
from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.attention import RelPosMultiHeadSelfAttention
from avec_tpu_torch.serve import Server
from avec_tpu_torch.utils import media

from test_torch_kernels import cuda_device  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(vocab_size=256, num_blocks=(2, 2, 1), interctc_blocks=())


@pytest.mark.cuda
def test_causal_transcriber_exact_on_the_card(cuda_device):
    model = AudioEfficientConformerInterCTC(
        device=cuda_device, causal=True, left_context=64,
        generator=torch.Generator().manual_seed(0), **SMALL)
    with torch.no_grad():
        randomize_batch_stats(model, torch.Generator().manual_seed(1))
    n = 53000
    audio = (np.random.RandomState(0).randn(n) * 0.1).astype(np.float32)
    st = CausalStreamingTranscriber(model, CTCGreedySearchDecoder(),
                                    chunk_frames=16)
    st.collect_logits = True
    for s in range(0, n, 4100):
        st.push(audio[s: s + 4100])
    st.finish()
    got = np.concatenate(st.logits_chunks)[:st._o_total]
    with torch.no_grad():
        logits, lengths = model(
            torch.from_numpy(audio[None]).to(cuda_device),
            torch.tensor([n], dtype=torch.int32,
                         device=cuda_device))["outputs"]
    want = logits[0].cpu().numpy()
    assert got.shape == want.shape == (_od(_od(_od(n // 160 + 1))), 256)
    assert len(st.push_latencies) == -(-(n // 160 + 1) // 16)
    assert np.abs(got - want).max() <= 2e-4
    assert st._tokens == _collapse_host(want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_xl_attention_cache_card_vs_cpu(cuda_device, dtype, tol):
    d, heads, th, tq = 256, 4, 32, 8
    gen = torch.Generator().manual_seed(0)
    att = RelPosMultiHeadSelfAttention(d, heads, causal=True)
    with torch.no_grad():
        for p in att.parameters():
            p.uniform_(-0.1, 0.1, generator=gen)
    x = torch.randn(2, tq, d, generator=gen)
    hidden = {k: torch.randn(2, th, d, generator=gen) for k in ("K", "V")}
    i = torch.arange(tq)[:, None]
    j = torch.arange(th + tq)[None, :]
    mask = ((j >= i) & (j <= th + i) & (j >= 4))[None, None]
    with torch.no_grad():
        want, want_h = att(x, mask=mask, hidden=hidden, return_hidden=True)
        att.to(cuda_device)
        got, got_h = att(x.to(cuda_device, dtype), mask=mask.to(cuda_device),
                         hidden={k: v.to(cuda_device, dtype)
                                 for k, v in hidden.items()},
                         return_hidden=True)
    scale = float(want.abs().max())
    assert float((got.float().cpu() - want).abs().max()) <= tol * max(scale,
                                                                         1.0)
    for k in ("K", "V"):
        assert float((got_h[k].float().cpu() - want_h[k]).abs().max()) <= \
            tol * max(float(want_h[k].abs().max()), 1.0)


@pytest.mark.cuda
def test_served_file_batch_launches_flash(cuda_device, tmp_path):
    """Three wav and one flac request at the AO widths with use_flash (3
    flash layers at blocks (2, 2, 1)): 3 K4 launches per forward; in fp32
    the same token ids through the kernels' plain versions; the flac file
    serves as its wav does."""
    srv = Server(mode="ao", device=cuda_device, precision="float32",
                 use_flash=True, **SMALL)
    with torch.no_grad():
        randomize_batch_stats(srv.model, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(1)
    paths = []
    for i, n in enumerate((20000, 41000, 33000)):
        path = str(tmp_path / f"u{i}.wav")
        media.write_audio(path, (rng.randn(n) * 0.1).astype(np.float32))
        paths.append(path)
    flac = str(tmp_path / "u0.flac")
    media.write_audio(flac, media.read_audio(paths[0])[0])
    paths.append(flac)
    _cuda.reset_launches()
    rows = srv.transcribe_batch(paths)
    torch.cuda.synchronize()
    assert dict(_cuda.launches) == {"flash_attention_fwd": 3}
    srv.model.set_kernels(False)
    plain = srv.transcribe_batch(paths)
    srv.model.set_kernels(True)
    assert [r["tokens"] for r in rows] == [r["tokens"] for r in plain]
    assert rows[3]["tokens"] == rows[0]["tokens"]
    assert all(r["batch_size"] == 4 for r in rows)
