#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`avec_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # build, check, serve, time
    python3 chip_smoke.py --profile  # also trace one served forward

Phases, in order; any failure raises and the exit code is non-zero:
 1. device and build: require CUDA, print the card's name and power limit,
    build the CUDA kernels from `avec_tpu_torch/csrc` (nvcc, sm_90a);
 2. each kernel against its plain PyTorch version at the serving shapes, in
    fp32 (max abs <= 1e-4) and bf16 (flash <= 2e-2, stem exact);
 3. serving at full width: the reference-depth AV model (61.7M params,
    vocab 256, use_flash, stem "pallas", seeded random weights and BN
    statistics) answers 8 seeded requests of 2-6 s in rounds; the flash
    kernel must launch 7 times and the stem kernel once per forward; the
    same batch through the kernels' plain versions in fp32 must give logits
    within 2e-3 and identical greedy token ids;
 4. kernel timings (CUDA events) beside their bounds, the plain versions and
    a PyTorch library call where one computes the same function.
The line before the last is a JSON `kernels` line; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
ROUNDS = 5                         # served batches in the timed main path


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def make_requests(rng, n: int = 8):
    """Seeded requests of 2-6 s (the first is 6 s, so the batch falls in the
    8 s bucket): tones that change every 0.12 s and 25 fps 88x88 frames."""
    secs = [6.0] + list(rng.uniform(2.0, 6.0, n - 1))
    reqs = []
    for s in secs:
        samples, seg = int(16000 * s), 1920
        freq = np.repeat(rng.uniform(100, 4000, samples // seg + 1), seg)
        amp = np.repeat(rng.uniform(0.0, 0.5, samples // seg + 1), seg)
        audio = amp[:samples] * np.sin(2 * np.pi * np.cumsum(freq[:samples])
                                       / 16000)
        frames = samples // 640 + 1
        video = rng.rand(frames, 88, 88, 1) * rng.rand(frames, 1, 1, 1) * 2
        reqs.append({"audio": audio.astype(np.float32),
                     "video": video.astype(np.float32)})
    return reqs


def stage_lengths(audio_len: np.ndarray):
    """Audio frame lengths at the flash stages: fbank, stem stride, then the
    strided boundary blocks (T = 801 -> 401 -> 201 -> 101 in the 8 s
    bucket)."""
    fb = audio_len // 160 + 1
    s0 = (fb - 1) // 2 + 1
    s1 = (s0 - 1) // 2 + 1
    return s1, (s1 - 1) // 2 + 1


def flash_inputs(b, t, d_model, lengths, dtype, seed):
    from avec_tpu_torch.ops.flash_attention import rel_pos_augment

    h, d = 4, d_model // 4
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=gen) for _ in range(3))
    pos_kernel = torch.randn(d_model, d_model, generator=gen) / d_model ** 0.5
    pos_bias = torch.randn(d_model, generator=gen) * 0.1
    dev = torch.device("cuda")
    q, k, v = (a.to(dev, dtype) for a in (q, k, v))
    q_aug, k_aug = rel_pos_augment(q, k, pos_kernel.to(dev), pos_bias.to(dev),
                                   d_model, h)
    return (q_aug.contiguous(), k_aug.contiguous(), v.contiguous(),
            torch.as_tensor(lengths, dtype=torch.int32, device=dev),
            1.0 / math.sqrt(d))


def flash_cost(b, h, t, da, dv, lengths, es):
    """Bytes (q' read, the valid k'/v rows read, out and lse written) and
    operations (2 x T x len x (da + dv) per head) one launch needs."""
    valid = int(np.sum(lengths))
    nbytes = (b * h * t * da * es + valid * h * (da + dv) * es
              + b * h * t * dv * es + b * h * t * 4 + b * 4)
    ops = 2.0 * h * t * valid * (da + dv)
    return nbytes, ops


def bound(nbytes, ops, kind):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the "
              "card only", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from avec_tpu_torch.models.zoo import randomize_batch_stats
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                    flash_attention_reference)
    from avec_tpu_torch.ops.stem import bn_relu_pool, bn_relu_pool_reference
    from avec_tpu_torch.serve import Server, _batch_bucket, _bucket

    detail = {}
    dev = torch.device("cuda")

    # ---- 1. device and build
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s")
    for src, out in _cuda.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    detail["build_s"] = build_s
    detail["build_log"] = dict(_cuda.build_log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. kernels against their plain versions (serving shapes)
    ragged = {201: [201, 160, 120, 101, 77, 40, 9, 1],
              101: [101, 80, 60, 51, 39, 20, 5, 1]}
    errs = {"flash_attention_fwd": {}, "bn_relu_pool": {}}
    for t, d_model in ((201, 256), (101, 360)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, lens, scale = flash_inputs(8, t, d_model,
                                                ragged[t], dtype, seed=t)
            out, lse = flash_attention_fwd(q, k, v, lens, scale)
            torch.cuda.synchronize()
            want, want_lse = flash_attention_reference(q, k, v, lens, scale)
            err = max(max_abs(out, want), max_abs(lse, want_lse))
            key = f"T{t}_D{d_model}_{str(dtype)[6:]}"
            errs["flash_attention_fwd"][key] = err
            log(f"flash_attention_fwd {key}: max abs {err:.3e} (tol {tol})")
            if not err <= tol:
                raise AssertionError(f"flash kernel disagrees: {key} {err}")
    n_frames = 8 * (_bucket(96000) // 640 + 1)     # 8 x 201 video frames
    gen = torch.Generator().manual_seed(5)
    a5 = (torch.rand(64, generator=gen) + 0.5).to(dev)
    b5 = (torch.randn(64, generator=gen) * 0.2).to(dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.0)):
        y = torch.randn(n_frames, 44, 44, 64, generator=gen).to(dev, dtype)
        got = bn_relu_pool(y, a5, b5)
        torch.cuda.synchronize()
        err = max_abs(got, bn_relu_pool_reference(y, a5, b5))
        key = f"N{n_frames}_{str(dtype)[6:]}"
        errs["bn_relu_pool"][key] = err
        log(f"bn_relu_pool {key}: max abs {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"stem kernel disagrees: {key} {err}")
        del y, got
    detail["kernel_errors"] = errs

    # ---- 3. serving at full width
    srv = Server(device="cuda", precision="bfloat16", seed=0, vocab_size=256,
                 use_flash=True, stem_mode="pallas")
    with torch.no_grad():
        randomize_batch_stats(srv.model, torch.Generator().manual_seed(1))
    n_params = sum(p.numel() for p in srv.model.parameters())
    reqs = make_requests(np.random.RandomState(0))
    samples = [len(r["audio"]) for r in reqs]
    inputs = srv._inputs_for_batch(reqs, _bucket(max(samples)),
                                   _batch_bucket(len(reqs)))
    log(f"model: {n_params / 1e6:.2f}M params; batch of {len(reqs)} requests "
        f"({min(samples) / 16000:.2f}-{max(samples) / 16000:.2f} s) in the "
        f"{inputs[2].shape[1]}-sample bucket")
    srv.transcribe_batch(reqs)                       # warm-up (cuDNN plans)
    srv.latencies, srv.rtfs = [], []
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        results = srv.transcribe_batch(reqs)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    log(f"main path launches over {ROUNDS} forwards: {launches}")
    if launches.get("flash_attention_fwd", 0) != 7 * ROUNDS:
        raise AssertionError(f"flash launches {launches} != 7 per forward")
    if launches.get("bn_relu_pool", 0) != ROUNDS:
        raise AssertionError(f"stem launches {launches} != 1 per forward")
    summary = srv.stats_summary()
    serving = {"requests_per_s": len(reqs) * ROUNDS / wall,
               "latency_p50_s": summary["latency_p50_s"],
               "latency_p95_s": summary["latency_p95_s"],
               "rtf_mean": summary["rtf_mean"], "rounds": ROUNDS,
               "batch": len(reqs), "params_m": n_params / 1e6}

    logits, lengths = srv.forward(inputs)
    if not (tuple(logits.shape) == (8, 101, 256)
            and bool(torch.isfinite(logits.float()).all())):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    if [len(r["tokens"]) for r in results] == [0] * len(results):
        raise AssertionError("every request decoded to no token")

    def fwd_ms(kernels: bool, dtype) -> float:
        srv.model.set_kernels(kernels)
        return cuda_time_ms(lambda: srv.forward(inputs, dtype), iters=5,
                            warmup=1)

    order = [False, True, True, False]
    times = [fwd_ms(k, torch.bfloat16) for k in order]
    serving["forward_ms_kernels_bf16"] = (times[1] + times[2]) / 2
    serving["forward_ms_plain_bf16"] = (times[0] + times[3]) / 2

    srv.model.set_kernels(True)
    k_logits, k_len = srv.forward(inputs, torch.float32)
    srv.model.set_kernels(False)
    p_logits, p_len = srv.forward(inputs, torch.float32)
    srv.model.set_kernels(True)
    diff = max_abs(k_logits, p_logits)
    ids_k = srv.decoder(srv.decoder.device_fn((k_logits, k_len)))
    ids_p = srv.decoder(srv.decoder.device_fn((p_logits, p_len)))
    serving["fp32_kernel_vs_plain_logits_max_abs"] = diff
    serving["bf16_vs_fp32_plain_logits_max_abs"] = max_abs(logits, p_logits)
    log(f"fp32 kernels vs plain: logits max abs {diff:.3e} (tol 2e-3), "
        f"greedy ids equal: {ids_k == ids_p}")
    if not (diff <= 2e-3 and torch.equal(k_len, p_len) and ids_k == ids_p):
        raise AssertionError("kernel path disagrees with the plain path")
    log("serving " + json.dumps(serving))
    detail["serving"] = serving
    detail["tokens"] = [r["tokens"] for r in results]

    # ---- 4. kernel timings at the main path's shapes and data (bf16)
    alens = inputs[3]
    len1, len2 = stage_lengths(alens)
    flash = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
             "ops": 0.0}
    for t, d_model, lens, count in ((201, 256, len1, 6), (101, 360, len2, 1)):
        q, k, v, lt, scale = flash_inputs(8, t, d_model, lens,
                                          torch.bfloat16, seed=7)
        keymask = (torch.arange(t, device=dev)[None, :]
                   < lt[:, None])[:, None, None, :]
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, lt, scale))
        plain = cuda_time_ms(lambda: flash_attention_reference(q, k, v, lt,
                                                               scale))
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keymask, scale=scale))
        nbytes, ops = flash_cost(8, 4, t, q.shape[-1], v.shape[-1], lens, 2)
        detail[f"flash_T{t}"] = {"ms": ms, "plain_ms": plain,
                                 "library_ms": lib, "bytes": nbytes,
                                 "ops": ops, "lengths": [int(x) for x in lens],
                                 "bound_ms": bound(nbytes, ops, "bf16")[0]}
        log(f"flash T={t} D={d_model}: {ms:.4f} ms/launch, plain {plain:.4f}, "
            f"sdpa {lib:.4f}, bound {bound(nbytes, ops, 'bf16')[0]:.5f}")
        flash["ms"] += count * ms
        flash["plain_ms"] += count * plain
        flash["library_ms"] += count * lib
        flash["bytes"] += count * nbytes
        flash["ops"] += count * ops
    f_bound, f_by = bound(flash["bytes"], flash["ops"], "bf16")

    y = torch.randn(n_frames, 44, 44, 64, generator=gen).to(dev, torch.bfloat16)
    s_ms = cuda_time_ms(lambda: bn_relu_pool(y, a5, b5))
    s_plain = cuda_time_ms(lambda: bn_relu_pool_reference(y, a5, b5))
    s_bytes = y.numel() * 2 + (y.numel() // 4) * 2 + 2 * 64 * 4
    s_bound, s_by = bound(s_bytes, 3.0 * y.numel(), "bf16")
    detail["stem"] = {"ms": s_ms, "plain_ms": s_plain, "bytes": s_bytes,
                      "bound_ms": s_bound}
    log(f"bn_relu_pool N={n_frames}: {s_ms:.4f} ms, plain {s_plain:.4f}, "
        f"bound {s_bound:.5f}")

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "avec_tpu_torch/csrc/flash_attention.cu",
         "replaces": "avec_tpu/ops/pallas_attention.py:134",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": max(errs["flash_attention_fwd"].values()),
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": flash["library_ms"]},
        {"name": "bn_relu_pool", "route": "cuda",
         "source": "avec_tpu_torch/csrc/stem.cu",
         "replaces": "avec_tpu/ops/pallas_stem.py:149",
         "launches": launches["bn_relu_pool"],
         "max_abs_err": max(errs["bn_relu_pool"].values()),
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None},
    ]
    detail["kernels"] = kernels

    if "--profile" in sys.argv[1:]:
        detail["profile"] = profile_forward(srv, inputs)

    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, **detail}, f, indent=1, default=str)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in (("flash kernel (K4)", ("flash_fwd_kernel",)),
                      ("stem kernel (K5)", ("bn_relu_pool_kernel",)),
                      ("host-to-device copy", ("memcpy htod",)),
                      ("device copy / cast", ("copy",)),
                      ("convolution", ("conv", "fprop", "implicit")),
                      ("matmul", ("gemm", "cublas", "cutlass", "xmma"))):
        if any(k in low for k in keys):
            return cat
    return "elementwise / reduction / other"


def profile_forward(srv, inputs):
    """Device time of one served bf16 forward: kernels only (the CPU-side
    operator rows are left out so nothing counts twice), by category and by
    kernel name, beside the forward's CUDA-event time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    srv.model.set_kernels(True)
    fwd_ms = cuda_time_ms(lambda: srv.forward(inputs), iters=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        srv.forward(inputs)
        torch.cuda.synchronize()
    rows, cats = [], {}
    for e in p.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.count, e.key))
            cat = _category(e.key)
            cats[cat] = cats.get(cat, 0.0) + us / 1e3
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"profile: forward {fwd_ms:.3f} ms (CUDA events), device busy "
        f"{busy:.3f} ms in the traced forward, idle share "
        f"{max(0.0, 1 - busy / fwd_ms):.3f}")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.4f} ms  {cat}")
    for us, count, key in rows[:12]:
        log(f"  {us / 1e3:9.4f} ms {count:5d}x {key[:100]}")
    return {"forward_ms": fwd_ms, "busy_ms": busy, "categories_ms": cats,
            "top": [{"ms": us / 1e3, "count": c, "name": k}
                    for us, c, k in rows[:40]]}


if __name__ == "__main__":
    sys.exit(main())
