"""The port's CUDA kernels (flash attention K4, stem K5) against their plain
PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where JAX
is absent. On a machine with an NVIDIA H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q

Tests marked `cuda` decide inside a fixture whether a card is present and
skip without one; the others run on the CPU, where each wrapper computes its
plain version. Tolerances: fp32 max abs 1e-4; flash bf16 2e-2 (bf16 inputs,
fp32 accumulation in both); stem bf16 exact (a max of identically rounded
values); whole-model fp32 logits 2e-3.
"""

import numpy as np
import pytest
import torch

from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                flash_attention_reference)
from avec_tpu_torch.ops.stem import bn_relu_pool, bn_relu_pool_reference

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _flash_inputs(device, dtype, t, da, dv, lengths, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(len(lengths), 4, t, d, generator=gen)
               for d in (da, da, dv))
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [a.to(device, dtype) for a in (q, k, v)] + [lens.to(device)]


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper returns its plain version and launches
    nothing."""
    before = dict(_cuda.launches)
    q, k, v, lens = _flash_inputs("cpu", torch.float32, 19, 13, 6, [19, 1])
    out, lse = flash_attention_fwd(q, k, v, lens, 0.5)
    want, want_lse = flash_attention_reference(q, k, v, lens, 0.5)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    y = torch.randn(3, 9, 10, 8)
    a, b = torch.rand(8) + 0.5, torch.randn(8)
    got = bn_relu_pool(y, a, b)
    assert got.shape == (3, 5, 5, 8)
    assert torch.equal(got, bn_relu_pool_reference(y, a, b))
    assert dict(_cuda.launches) == before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without nvcc the build raises."""
    if _cuda._libs:
        pytest.skip("kernels already built in this process")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,da,dv,lengths", [
    (201, 321, 64, [201, 160, 77, 1]),   # audio stage 1 of the 8 s bucket
    (101, 451, 90, [101, 51, 5, 1]),     # audio stage 2
    (37, 20, 7, [37, 0, 36, 2]),         # ragged widths, a row of length 0
])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, t, da, dv,
                                    lengths):
    q, k, v, lens = _flash_inputs(cuda_device, dtype, t, da, dv, lengths)
    n0 = _cuda.launches["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, lens, 0.125)
    torch.cuda.synchronize()
    assert _cuda.launches["flash_attention_fwd"] == n0 + 1
    want, want_lse = flash_attention_reference(q, k, v, lens, 0.125)
    assert out.dtype == dtype and out.shape == want.shape
    assert _err(out, want) <= tol
    assert _err(lse, want_lse) <= tol


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_inputs(cuda_device):
    q, k, v, lens = _flash_inputs(cuda_device, torch.float32, 16, 8, 8, [16])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v, lens)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_fwd(q, k, v, lens.long())
    with pytest.raises(ValueError, match="d_v"):
        v2 = torch.zeros(1, 4, 16, 100, device=cuda_device)
        flash_attention_fwd(q, k, v2, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0)])
def test_stem_kernel_matches_plain(cuda_device, dtype, tol):
    gen = torch.Generator().manual_seed(1)
    y = torch.randn(37, 44, 44, 64, generator=gen).to(cuda_device, dtype)
    a = (torch.rand(64, generator=gen) + 0.5).to(cuda_device)
    b = (torch.randn(64, generator=gen) * 0.2).to(cuda_device)
    n0 = _cuda.launches["bn_relu_pool"]
    got = bn_relu_pool(y, a, b)
    torch.cuda.synchronize()
    assert _cuda.launches["bn_relu_pool"] == n0 + 1
    assert got.shape == (37, 22, 22, 64) and got.dtype == dtype
    assert _err(got, bn_relu_pool_reference(y, a, b)) <= tol


@pytest.mark.cuda
def test_model_kernel_path_matches_plain_path(cuda_device):
    """A small AV model on the card: the kernel path (7 -> here 3 flash
    launches and 1 stem launch per forward) against the plain versions."""
    from avec_tpu_torch.serve import Server, _bucket

    srv = Server(device="cuda", precision="float32", vocab_size=32,
                 v_num_blocks=(2, 1), a_num_blocks=(2, 2, 1), f_num_blocks=2,
                 v_interctc_blocks=(2,), a_interctc_blocks=(2, 4),
                 f_interctc_blocks=(1,), use_flash=True, stem_mode="pallas")
    rng = np.random.RandomState(0)
    reqs = [{"audio": (rng.randn(n) * 0.1).astype(np.float32),
             "video": rng.rand(n // 640 + 1, 88, 88, 1).astype(np.float32)}
            for n in (16000, 27200)]
    inputs = srv._inputs_for_batch(reqs, _bucket(27200), 2)
    _cuda.reset_launches()
    got, got_len = srv.forward(inputs)
    assert dict(_cuda.launches) == {"flash_attention_fwd": 3,
                                    "bn_relu_pool": 1}
    srv.model.set_kernels(False)
    want, want_len = srv.forward(inputs)
    assert torch.equal(got_len, want_len)
    assert _err(got, want) <= 2e-3
