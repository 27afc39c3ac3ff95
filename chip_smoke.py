#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`avec_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # build, check, serve, train, time
    python3 chip_smoke.py --profile  # also trace one served forward and one
                                     # train step of each training path

Phases, in order; any failure raises and the exit code is non-zero:
 1. device and build: require CUDA, print the card's name and power limit,
    build the CUDA kernels from `avec_tpu_torch/csrc` (nvcc, sm_90a) and
    print each kernel's registers and spill bytes as ptxas reports them;
 2. each kernel against its plain PyTorch version at the serving shapes, in
    fp32 (max abs <= 1e-4) and bf16 (flash <= 2e-2, stem exact);
 3. serving at full width: the reference-depth AV model (61.7M params,
    vocab 256, use_flash, stem "pallas", seeded random weights and BN
    statistics) answers 8 seeded requests of 2-6 s in rounds; the flash
    kernel must launch 7 times and the stem kernel once per forward; the
    same batch through the kernels' plain versions in fp32 must give logits
    within 2e-3 and identical greedy token ids;
 4. kernel timings (CUDA events) beside their bounds, the plain versions and
    a PyTorch library call where one computes the same function;
 5. the training kernels against their plain versions at the training
    shapes: fused FFN forward and backward for (d, F) = (180, 720),
    (256, 1024), (360, 1440) at N = 16 x T rows, fp32 and bf16, dropout off
    and 0.1 with a fixed seed (the hash masks must agree exactly); flash
    backward at (T, D) = (151, 256) and (76, 360) with ragged lengths down to
    1 and one 0. Every error is the max abs difference over the largest entry
    of the plain result: fp32 1e-4 (y, dx, dq', dk', dv) and 3e-4 (FFN
    parameter gradients, atomic sums over thousands of rows); bf16 2e-2 and
    3e-2; the bf16 FFN forward bit-identical over two calls;
 6. training at full width: the same 61.7M-parameter model, use_flash, fused
    FFN (`fused_ffn=True`), stem "2d", bf16 compute on fp32 parameters, B=16 utterances of
    3-6 s in 6 s of padding (151 frames of 88x88, 32 labels), dropout 0.1 and
    SpecAugment on: 1 warm-up + 3 counted steps. Losses and gradient norm
    must be finite, every parameter must have a gradient, at least 99% of
    the leaves and every BN running statistic must move, and the launches
    per step must equal the counts derived from the module tree. Then, in
    fp32 with dropout and SpecAugment off, one forward + backward through
    the kernels against one through their plain versions: total loss and
    gradient norm within 1e-3, every gradient leaf within 2e-3 of its
    largest entry, every BN running statistic within 1e-5;
 7. train-step time, utterances/s and peak memory with the kernels and with
    their plain versions (interleaved), and each training kernel's time at
    the step's shapes beside its bound, plain version and library call (for
    K1 / K1b the port's own unfused feed-forward module, the `fused_ffn=False`
    route, forward and backward); K1's device time by kernel (its three
    stages) and the host's time to issue it, beside its time through the
    wrapper.
 8. the fused attention module's kernels (K2 forward, K2b backward) against
    the plain version at (B, T, d, H) = (16, 151, 256, 4) and (16, 76, 360,
    4), fp32 and bf16, lengths from T down to 1 and one 0, dropout 0 and 0.1
    (exactly the hash mask's entries dropped on both sides), with and without
    the residual: y, dx and every parameter gradient, max abs over the
    largest entry; fp32 1e-4 (y) and 5e-4 (gradients), bf16 2e-2 and 3e-2;
 9. the train-mode stem (`fused_stem_train`) on the card, B=16 x 151 frames,
    kernel route against plain route: pooled (fp32 1e-5, bf16 exact), mean,
    var, the gradients of the conv weight, BN scale and BN bias, and a
    conv-bias gradient of exactly zero;
10. training at full width through those kernels: fused attention, fused
    FFN (both switched on explicitly), stem "pallas", use_flash off: the
    launch counts per step must be 19 + 19 attention, 48 + 48 FFN, 1 stem
    and no flash; 1 warm-up + 3 counted steps with the checks of phase 6;
    then fp32 kernels against plain versions (loss 1e-5, gradient norm
    1e-3, every leaf 2e-3, BN statistics 1e-5);
11. step time, utterances/s and peak memory of that path and of phase 6's
    path, interleaved in this one call, and the attention kernels' times per
    launch and per step beside their bounds, the plain version and the
    port's own unfused attention module (PyTorch library calls);
12. the fused convolution module's kernels (K3-stats, K3-fwd, K3b-1, K3b-2)
    against the plain stages at (B, T, d = E, k) = (16, 301, 180, 15),
    (16, 151, 256, 15) and (16, 76, 360, 15), fp32 and bf16, padding "same"
    and "causal", dropout 0 and 0.1 (exactly the hash mask's entries dropped
    on both sides): y, mean, var, dx and the ten parameter gradients, max abs
    over the largest entry; fp32 1e-4 (y, mean, var) and 5e-4 (gradients),
    bf16 2e-2 and 3e-2; the depthwise-bias gradient exactly zero; in bf16,
    K3b-2's dx and five gradients bit-identical over two calls on the same
    inputs;
13. training at full width through all the training kernels: fused
    convolution module, fused attention, fused FFN (all three switched on
    explicitly), stem "pallas", use_flash off: the launch counts per step
    must be 21 of each conv kernel, 19 + 19 attention, 48 + 48 FFN, 1 stem
    and no flash; 1 warm-up + 3 counted steps with the checks of phase 6;
    then fp32 kernels against plain versions (loss 1e-5, gradient norm
    1e-3, every leaf 2e-3, BN statistics 1e-5);
14. K3 / K3b times per launch and per step beside their device times,
    bounds, the plain stages and the port's own unfused convolution module
    (PyTorch library calls), K3b-2's device time by kernel (its nine
    stages) and the host's time to issue each pass, and step time,
    utterances/s and peak memory of phase 13's path
    and phase 10's path (they differ by `fused_conv` alone), interleaved;
15. K3dp on two gloo ranks sharing the card (`avec_tpu_torch.parallel.dist
    .spawn`): each rank runs the four conv passes on its half of phase 12's
    (16, T, d) inputs with the statistics all-reduced between them, against
    the plain DP stages on the card (masks of the rank's seed identical at
    dropout 0.1) and, at dropout 0, y and dx concatenated, mean and var, and
    the parameter gradients summed over the ranks against one K3/K3b call on
    the whole batch: fp32 1e-4 (y, mean, var) and 5e-4 (gradients), bf16
    2e-2 and 3e-2; then, at the step's B=8 shapes, the port's unfused module
    under sync-BN and the all-reduce of the (2E,) statistics over gloo;
16. data-parallel training at full width: the same model, `data_parallel`,
    fused conv (K3dp), fused attention, fused FFN, stem "2d", bf16, the 16
    utterances of phase 6 split 8 + 8 over two gloo ranks on the card: 1
    warm-up + 3 counted steps with the checks of phase 6 on each rank, 21 of
    each K3dp pass, 19 + 19 attention and 48 + 48 FFN launches per step and
    rank, parameters bit-identical across the ranks after the steps; then an
    fp32 step with dropout and SpecAugment off against the single-process
    step on the same utterances (loss 1e-5, gradient norm 1e-3, every leaf
    2e-3, BN statistics 1e-5); step ms, global utterances/s and peak memory
    per rank, two ranks time-sliced on one card (not a data-parallel speed);
17. NCCL at world size 1: the data-parallel trainer against the plain one,
    fp32, dropout off, the same 16 utterances: through the kernels' plain
    versions with cuDNN deterministic, losses and every gradient leaf (over
    its largest entry) within 1e-6; through the kernels, losses within 1e-6
    and the gradients printed beside the plain trainer's own run-to-run
    floor (the kernels' atomic sums vary in their last bits);
then the K3dp passes' times per rank at the B=8 shapes beside their
bounds and plain stages. The line before the last is a JSON `kernels` line of
sixteen kernels; the last line is {"ok": true, "device": {...}}. Every time
there ("ms", "plain_ms", "library_ms") is one of direct calls between CUDA
events (`cuda_time_ms`), the host's cost of each call included; "device_ms"
is the same call's device time from torch.profiler (`device_time_ms`), the
time of every kernel it runs. Details go
to chiprun_out/chip_smoke.json.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
ROUNDS = 3                         # served batches in the timed main path
TRAIN_STEPS = 3                    # counted train steps after one warm-up


# B=16 lengths for the kernel checks at the training shapes: T, short ones, 0
# gradient leaves of the video stem and ResNet trunk (see check_agreement)
FRONT_END = "video_encoder.front_end."
RAGGED_TRAIN_LENGTHS = {
    151: [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33, 17, 2, 1, 0],
    76: [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2, 1, 0]}
ATT_LEAVES = ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "pos_w",
              "pos_b", "wo", "bo")


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled symbol (its last
    length-prefixed name component), with its template arguments, still
    mangled, in brackets."""
    i = 3 if mangled.startswith("_ZN") else 0
    names = []
    while True:
        m = re.match(r"\d+", mangled[i:])
        if not m:
            break
        i += len(m.group())
        names.append(mangled[i:i + int(m.group())])
        i += int(m.group())
    name = names[-1] if names else mangled
    if mangled[i:i + 1] == "I":
        name += "<" + mangled[i + 1:].split("EE")[0] + ">"
    return name


def ptxas_summary(build_log) -> dict:
    """{source: {kernel: (registers, spill store bytes, spill load bytes)}}
    from nvcc's -Xptxas -v output."""
    out = {}
    for src, text in build_log.items():
        kern, stores, loads = None, 0, 0
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kern = kernel_name(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                stores, loads = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and kern is not None:
                out.setdefault(src, {})[kern] = (int(m.group(1)), stores, loads)
                kern, stores, loads = None, 0, 0
    return out


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


def device_time_ms(fn, iters: int = 10):
    """Device time of one `fn()`: the kernels (and device memsets and copies)
    that it runs, traced by torch.profiler over `iters` calls after a
    warm-up call, in ms per call, as (total, {kernel name: ms}). Unlike
    `cuda_time_ms` it leaves out the host's cost of each call and the gaps
    between kernels."""
    fn()
    torch.cuda.synchronize()
    per = {}
    for us, _, key in traced_device_rows(fn, iters):
        name = short_kernel(key)
        per[name] = per.get(name, 0.0) + us / 1e3 / iters
    return sum(per.values()), per


def traced_device_rows(fn, iters: int = 1):
    """(device us, count, name) of each kernel, device memset or copy that
    `iters` calls of `fn` run, traced by torch.profiler; the CPU-side
    operator rows are left out so nothing counts twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in p.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.count, e.key))
    return rows


def host_ms(fn, iters: int = 20) -> float:
    """Host time to issue one `fn()`: `iters` calls timed on the host's
    clock with no synchronisation between them (few enough launches that
    the launch queue never fills and makes the host wait)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - start) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def short_kernel(name: str) -> str:
    """A profiler's demangled kernel signature cut to the kernel's own name
    and template arguments: `void avec::(anonymous namespace)::k<3>(...)`
    -> `k<3>`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            cut = i
            break
    name, depth, start = name[:cut], 0, 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:].strip()


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
    detail["ptxas"] = ptxas_summary(_cuda.build_log)
    for src, kernels_ in detail["ptxas"].items():
        for name, (regs, spill_st, spill_ld) in kernels_.items():
            log(f"  ptxas {src} {name}: {regs} registers, {spill_st} bytes "
                f"spill stores, {spill_ld} bytes spill loads")
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
    flash = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bytes": 0, "ops": 0.0}
    for t, d_model, lens, count in ((201, 256, len1, 6), (101, 360, len2, 1)):
        q, k, v, lt, scale = flash_inputs(8, t, d_model, lens,
                                          torch.bfloat16, seed=7)
        keymask = (torch.arange(t, device=dev)[None, :]
                   < lt[:, None])[:, None, None, :]
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, lt, scale))
        dev_ms = device_time_ms(lambda: flash_attention_fwd(q, k, v, lt,
                                                            scale))[0]
        plain = cuda_time_ms(lambda: flash_attention_reference(q, k, v, lt,
                                                               scale))
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keymask, scale=scale))
        nbytes, ops = flash_cost(8, 4, t, q.shape[-1], v.shape[-1], lens, 2)
        detail[f"flash_T{t}"] = {"ms": ms, "device_ms": dev_ms,
                                 "plain_ms": plain,
                                 "library_ms": lib, "bytes": nbytes,
                                 "ops": ops, "lengths": [int(x) for x in lens],
                                 "bound_ms": bound(nbytes, ops, "bf16")[0]}
        log(f"flash T={t} D={d_model}: {ms:.4f} ms/launch (device "
            f"{dev_ms:.4f}), plain {plain:.4f}, "
            f"sdpa {lib:.4f}, bound {bound(nbytes, ops, 'bf16')[0]:.5f}")
        flash["ms"] += count * ms
        flash["device_ms"] += count * dev_ms
        flash["plain_ms"] += count * plain
        flash["library_ms"] += count * lib
        flash["bytes"] += count * nbytes
        flash["ops"] += count * ops
    f_bound, f_by = bound(flash["bytes"], flash["ops"], "bf16")

    y = torch.randn(n_frames, 44, 44, 64, generator=gen).to(dev, torch.bfloat16)
    s_ms = cuda_time_ms(lambda: bn_relu_pool(y, a5, b5))
    s_dev = device_time_ms(lambda: bn_relu_pool(y, a5, b5))[0]
    s_plain = cuda_time_ms(lambda: bn_relu_pool_reference(y, a5, b5))
    s_bytes = y.numel() * 2 + (y.numel() // 4) * 2 + 2 * 64 * 4
    s_bound, s_by = bound(s_bytes, 3.0 * y.numel(), "bf16")
    detail["stem"] = {"ms": s_ms, "device_ms": s_dev, "plain_ms": s_plain,
                      "bytes": s_bytes, "bound_ms": s_bound}
    log(f"bn_relu_pool N={n_frames}: {s_ms:.4f} ms (device {s_dev:.4f}), "
        f"plain {s_plain:.4f}, bound {s_bound:.5f}")

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "avec_tpu_torch/csrc/flash_attention.cu",
         "replaces": "avec_tpu/ops/pallas_attention.py:134",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": max(errs["flash_attention_fwd"].values()),
         "ms": flash["ms"], "device_ms": flash["device_ms"],
         "plain_ms": flash["plain_ms"], "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": flash["library_ms"]},
        {"name": "bn_relu_pool", "route": "cuda",
         "source": "avec_tpu_torch/csrc/stem.cu",
         "replaces": "avec_tpu/ops/pallas_stem.py:149",
         "launches": launches["bn_relu_pool"],
         "max_abs_err": max(errs["bn_relu_pool"].values()),
         "ms": s_ms, "device_ms": s_dev, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": s_by, "library_ms": None},
    ]
    if "--profile" in sys.argv[1:]:
        detail["profile"] = profile_forward(srv, inputs)
    del srv, inputs, logits, k_logits, p_logits, y
    torch.cuda.empty_cache()

    # ---- 5-7. the training slice
    profile = "--profile" in sys.argv[1:]
    entries, trainer, batch = training_phases(detail, profile)
    kernels += entries

    # ---- 8-11. the fused attention module and the train-mode stem
    entries, stem_train_launches, trainer_att = fused_phases(
        detail, profile, trainer, batch)
    kernels += entries
    kernels[1]["launches_train_path"] = stem_train_launches
    del trainer
    torch.cuda.empty_cache()

    # ---- 12-14. the fused convolution module
    entries, conv_shapes = conv_phases(detail, profile, trainer_att, batch)
    kernels += entries
    del trainer_att
    torch.cuda.empty_cache()

    # ---- 15-17. data-parallel training (K3dp, sync-BN, NCCL)
    kernels += dp_phases(detail, conv_shapes)
    detail["kernels"] = kernels

    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, **detail}, f, indent=1, default=str)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rel_err(got, want) -> float:
    """Max abs difference over the largest entry of `want`."""
    return max_abs(got, want) / max(float(want.float().abs().max()), 1e-30)


def ffn_inputs(n, d, f, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen).to(dev, dtype)
    g = torch.randn(n, d, generator=gen).to(dev, dtype)
    params = [1.0 + 0.1 * torch.randn(d, generator=gen),
              0.1 * torch.randn(d, generator=gen),
              torch.randn(f, d, generator=gen) / d ** 0.5,
              0.1 * torch.randn(f, generator=gen),
              torch.randn(d, f, generator=gen) / f ** 0.5,
              0.1 * torch.randn(d, generator=gen)]
    return x, g, [p.to(dev) for p in params]


def ffn_run(x, g, params, drop, use_kernel, seed=1234):
    """y and the gradients of x and the six parameters."""
    from avec_tpu_torch.ops.ffn import fused_ffn

    leaves = [t.detach().requires_grad_(True) for t in [x] + params]
    y = fused_ffn(leaves[0], *leaves[1:], seed, 1e-6, drop, True, use_kernel)
    y.backward(g)
    return y.detach(), [t.grad for t in leaves]


def ffn_cost(n, d, f, es):
    """(forward bytes, forward ops, backward bytes, backward ops): x read and
    y written once, fp32 parameters read once (and their gradients written
    once in the backward, beside x, g and dx); two products forward
    (4 N d F), five in the backward (u again, ds, dW2, dW1, dh: 10 N d F)."""
    pbytes = 4 * (2 * d * f + f + 3 * d)
    return (2 * n * d * es + pbytes, 4.0 * n * d * f,
            3 * n * d * es + 2 * pbytes, 10.0 * n * d * f)


def flash_bwd_cost(h, t, da, dv, lengths, es):
    """Bytes and operations of the dq kernel and of the dk/dv kernel: each
    reads the valid rows of q', k', v, dO and lse, delta once and writes its
    (B*H, T, .) gradients; each forms s and dO V^T on the valid square, dq
    then one more product over d_a, dk/dv one over d_a and one over d_v."""
    lens = np.asarray(lengths, dtype=np.float64)
    valid, sq, b = float(lens.sum()), float((lens ** 2).sum()), len(lens)
    read = h * valid * (2 * da + 2 * dv) * es + h * valid * 8 + b * 4
    dq = (read + b * h * t * da * es, 2.0 * h * sq * (2 * da + dv))
    dkv = (read + b * h * t * (da + dv) * es,
           2.0 * h * sq * (2 * da + 2 * dv))
    return dq, dkv


def make_train_batch(rng, batch: int = 16, samples: int = 96000,
                     label_len: int = 32):
    """B utterances padded to 6 s (151 frames of 88x88), true lengths of
    3-6 s with the first one full, 32 labels each."""
    alen = np.array([samples] + [int(v) for v in rng.uniform(
        samples // 2, samples, batch - 1)], np.int32)
    frames = samples // 640 + 1
    video = rng.rand(batch, frames, 88, 88, 1).astype(np.float32)
    audio = (rng.randn(batch, samples) * 0.1).astype(np.float32)
    for i, n in enumerate(alen):
        audio[i, n:] = 0.0
        video[i, n // 640 + 1:] = 0.0
    labels = rng.randint(1, 256, size=(batch, label_len)).astype(np.int32)
    return {"inputs": [video, alen // 640 + 1, audio, alen],
            "targets": (labels, np.full((batch,), label_len, np.int32))}


def reorder(batch):
    """The batch with its two halves of utterances swapped."""
    def swap(a):
        h = len(a) // 2
        return np.concatenate([a[h:], a[:h]])

    return {"inputs": [swap(a) for a in batch["inputs"]],
            "targets": tuple(swap(a) for a in batch["targets"])}


def kernel_call_shapes(trainer, batch):
    """One forward in training mode with hooks: how often each fused-FFN
    shape (N, d, F) and each flash shape (T, D, lengths) occurs in a step."""
    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops.attention import RelPos1dMultiHeadAttention

    ffn, flash, hooks = {}, {}, []

    def on_ffn(mod, args):
        x = args[0]
        key = (x.shape[0] * x.shape[1], x.shape[2],
               mod.layers["1"].weight.shape[0])
        ffn[key] = ffn.get(key, 0) + 1

    def on_att(mod, args, kwargs):
        x, mask = args[0], kwargs.get("mask")
        lens = tuple(int(v) for v in mask[:, 0, 0, :].sum(dim=-1).tolist())
        key = (x.shape[1], x.shape[2], lens)
        flash[key] = flash.get(key, 0) + 1

    for m in trainer.model.modules():
        if isinstance(m, FeedForwardModule):
            hooks.append(m.register_forward_pre_hook(on_ffn))
        elif isinstance(m, RelPos1dMultiHeadAttention) and m.use_flash:
            hooks.append(m.register_forward_pre_hook(on_att,
                                                     with_kwargs=True))
    inputs, _ = trainer._to_device(batch)
    with torch.no_grad():
        trainer.model.encoder(*inputs)
    for hk in hooks:
        hk.remove()
    return ffn, flash


def counted_train_steps(trainer, batch, per_step, verbose: bool = True):
    """One warm-up step, then TRAIN_STEPS steps with the launch counts set to
    0 just before and read just after: the counts must equal `per_step` per
    step, the losses and the gradient norm must be finite, every parameter
    must have a gradient, and at least 99% of the leaves and every BN running
    statistic must move. Returns (per-step losses, launch counts). `verbose`
    off prints nothing (the second rank of a data-parallel run)."""
    from avec_tpu_torch.ops import _cuda

    say = log if verbose else (lambda *args: None)

    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()
              if "running_" in n}
    trainer.train_step(batch)                        # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    history = []
    for _ in range(TRAIN_STEPS):
        losses, infos = trainer.train_step(batch)
        history.append({**{k: float(v) for k, v in losses.items()},
                        "lr": infos["lr"],
                        "grad_norm": float(infos["grad_norm"])})
    torch.cuda.synchronize()
    train_launches = dict(_cuda.launches)
    say(f"main path launches over {TRAIN_STEPS} train steps: {train_launches}")
    for row in history:
        say("  step " + json.dumps({k: round(v, 6) if k != "lr" else v
                                    for k, v in row.items()}))
    if train_launches != {k: v * TRAIN_STEPS for k, v in per_step.items()}:
        raise AssertionError(f"launches {train_launches} != {TRAIN_STEPS} x "
                             f"{per_step}")
    if len(history[-1]) != 9 or not all(
            math.isfinite(v) for row in history for v in row.values()):
        raise AssertionError(f"losses or gradient norm not finite: {history}")
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    changed = sum(not torch.equal(p, before[n])
                  for n, p in model.named_parameters())
    stuck = [n for n, b in model.named_buffers()
             if n in stats0 and torch.equal(b, stats0[n])]
    say(f"  parameters without gradient: {len(no_grad)}; leaves changed "
        f"{changed}/{len(before)}; BN statistics that did not move: "
        f"{len(stuck)}/{len(stats0)}")
    if no_grad or changed < 0.99 * len(before) or stuck:
        raise AssertionError(f"no_grad {no_grad[:5]} changed {changed} "
                             f"stuck {stuck[:5]}")
    return history, train_launches


def compare_fp32_step(model, batch, loss_tol):
    """fp32, dropout and SpecAugment off: one forward + backward through the
    kernels against one through their plain versions (which must launch
    nothing), held by `check_agreement`; every BN running statistic the two
    passes leave (each from the same starting point) within 1e-5."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    trainer32 = Trainer(model=model, device="cuda", precision="float32",
                        loss=CTCLoss(zero_infinity=True))
    stats = {n: b for n, b in model.named_buffers() if "running_" in n}
    start = {n: b.clone() for n, b in stats.items()}
    model.set_regularization(False)
    model.set_kernels(True)
    loss_k, grads_k = trainer32.loss_and_grads(batch)
    stats_k = {n: b.clone() for n, b in stats.items()}
    with torch.no_grad():
        for n, b in stats.items():
            b.copy_(start[n])
    model.set_kernels(False)
    _cuda.reset_launches()
    loss_p, grads_p = trainer32.loss_and_grads(batch)
    if dict(_cuda.launches):
        raise AssertionError(f"plain path launched {dict(_cuda.launches)}")
    model.set_kernels(True)
    model.set_regularization(True)
    return check_agreement("fp32 kernels vs plain",
                           (float(loss_k["loss"]), grads_k, stats_k),
                           (float(loss_p["loss"]), grads_p, stats), loss_tol)


def check_agreement(what, got, want, loss_tol, front_end_tol=2e-3):
    """Two fp32 steps, each (total loss, gradients by name, BN running
    statistics by name), `want` the reference: total loss within `loss_tol`
    and gradient norm within 1e-3, relative; every gradient leaf within 2e-3
    of its largest entry (leaves below 1e-6 of the largest gradient entry,
    the analytically zero key and positional biases, left out), the video
    front end's (stem and ResNet trunk) within `front_end_tol`; every BN
    running statistic within 1e-5, absolute. Logs and returns the errors,
    raises if one is out of tolerance."""
    (lk, grads_k, stats_k), (lp, grads_p, stats_p) = got, want
    stats_err = max(max_abs(stats_k[n], b) for n, b in stats_p.items())

    def gnorm(grads):
        return float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))

    nk, npl = gnorm(grads_k), gnorm(grads_p)
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    rows, noise = [], 0
    for name, gp in grads_p.items():
        leaf_max = float(gp.abs().max())
        if leaf_max <= 1e-6 * gmax:
            noise += 1          # analytically zero: key and positional biases
            continue
        rows.append((max_abs(grads_k[name], gp) / leaf_max, leaf_max, name))
    rows.sort(reverse=True)
    front = [r for r in rows if FRONT_END in r[2]]
    rest = [r for r in rows if FRONT_END not in r[2]]
    log(f"{what}: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {loss_tol}); grad norm "
        f"{nk:.6f} vs {npl:.6f} (rel {abs(nk - npl) / npl:.2e}, tol 1e-3); "
        f"{len(rows)} leaves compared, {noise} below 1e-6 of the largest "
        "gradient left out")
    for err, leaf_max, name in rows[:5]:
        log(f"  leaf {name}: max abs diff / max abs {err:.2e} "
            f"(max abs {leaf_max:.3e})")
    log(f"  worst leaf outside the video front end: {rest[0][2]} "
        f"{rest[0][0]:.2e} (tol 2e-3); inside it: {front[0][2]} "
        f"{front[0][0]:.2e} (tol {front_end_tol})")
    out = {"fp32_loss_rel": abs(lk - lp) / abs(lp),
           "fp32_grad_norm_rel": abs(nk - npl) / npl,
           "fp32_worst_leaf_rel": rows[0][0], "fp32_worst_leaf": rows[0][2],
           "fp32_worst_leaf_outside_front_end_rel": rest[0][0],
           "fp32_worst_front_end_leaf_rel": front[0][0],
           "fp32_bn_stats_max_abs": stats_err}
    log(f"  BN running statistics: max abs {stats_err:.2e} over "
        f"{len(stats_p)} buffers (tol 1e-5)")
    if not (abs(lk - lp) <= loss_tol * abs(lp)
            and abs(nk - npl) <= 1e-3 * npl and rest[0][0] <= 2e-3
            and front[0][0] <= front_end_tol and stats_err <= 1e-5):
        raise AssertionError(f"{what} disagree: {out}")
    return out


def training_phases(detail, profile: bool):
    """Phases 5-7; returns the four training kernels' entries."""
    import torch.nn.functional as F

    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops.ffn import KERNEL_BWD, KERNEL_FWD, fused_ffn
    from avec_tpu_torch.ops.flash_attention import (
        KERNEL_DKV, KERNEL_DQ, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd)
    from avec_tpu_torch.ops.layers import init_params
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    dev = torch.device("cuda")
    errs = {KERNEL_FWD: {}, KERNEL_BWD: {}, KERNEL_DQ: {}, KERNEL_DKV: {}}
    abs_errs = {k: 0.0 for k in errs}

    # ---- 5. training kernels against their plain versions
    names = ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")
    for n, d, f in ((16 * 301, 180, 720), (16 * 151, 256, 1024),
                    (16 * 76, 360, 1440)):
        for dtype, tol, wtol in ((torch.float32, 1e-4, 3e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = ffn_inputs(n, d, f, dtype, seed=d)
            for drop in (0.0, 0.1):
                y, grads = ffn_run(x, g, params, drop, True)
                torch.cuda.synchronize()
                want_y, want = ffn_run(x, g, params, drop, False)
                key = f"N{n}_d{d}_F{f}_{str(dtype)[6:]}_drop{drop}"
                e_fwd = rel_err(y, want_y)
                e_bwd = {nm: rel_err(a, b)
                         for nm, a, b in zip(names, grads, want)}
                errs[KERNEL_FWD][key] = e_fwd
                errs[KERNEL_BWD][key] = e_bwd
                if dtype == torch.float32:
                    abs_errs[KERNEL_FWD] = max(abs_errs[KERNEL_FWD],
                                               max_abs(y, want_y))
                    abs_errs[KERNEL_BWD] = max(
                        abs_errs[KERNEL_BWD],
                        *(max_abs(a, b) for a, b in zip(grads, want)))
                if drop and not torch.equal(y == 0, want_y == 0):
                    raise AssertionError(f"dropout masks differ: {key}")
                worst_w = max(v for nm, v in e_bwd.items() if nm != "x")
                log(f"fused_ffn {key}: y {e_fwd:.2e} dx {e_bwd['x']:.2e} "
                    f"(tol {tol}) params {worst_w:.2e} (tol {wtol})")
                if not (e_fwd <= tol and e_bwd["x"] <= tol
                        and worst_w <= wtol):
                    raise AssertionError(f"FFN kernels disagree: {key} "
                                         f"{e_fwd} {e_bwd}")
            if dtype == torch.bfloat16:
                # K1 sums its hidden-range partials in a fixed order
                with torch.no_grad():
                    ys = [fused_ffn(x, *params, 1234, 1e-6, 0.1, True)
                          for _ in range(2)]
                same = torch.equal(*ys)
                log(f"fused_ffn N{n}_d{d}_F{f}_bfloat16_drop0.1: forward "
                    f"bit-identical over two calls: {same}")
                if not same:
                    raise AssertionError(f"bf16 K1 reruns differ: N{n} d{d}")
            del x, g, params
    bwd_lengths = RAGGED_TRAIN_LENGTHS
    for t, d_model in ((151, 256), (76, 360)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, lens, scale = flash_inputs(16, t, d_model,
                                                bwd_lengths[t], dtype, seed=t)
            gen = torch.Generator().manual_seed(t + 1)
            dout = torch.randn(v.shape, generator=gen).to(dev, dtype)
            out, lse = flash_attention_fwd(q, k, v, lens, scale)
            delta = (dout.float() * out.float()).sum(-1).reshape(lse.shape)
            got = flash_attention_bwd(q, k, v, dout, lse, delta, lens, scale)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(q, k, v, dout, lse, delta,
                                                 lens, scale)
            e = [rel_err(a, b) for a, b in zip(got, want)]
            key = f"T{t}_D{d_model}_{str(dtype)[6:]}"
            errs[KERNEL_DQ][key] = e[0]
            errs[KERNEL_DKV][key] = max(e[1], e[2])
            if dtype == torch.float32:
                abs_errs[KERNEL_DQ] = max(abs_errs[KERNEL_DQ],
                                          max_abs(got[0], want[0]))
                abs_errs[KERNEL_DKV] = max(abs_errs[KERNEL_DKV],
                                           max_abs(got[1], want[1]),
                                           max_abs(got[2], want[2]))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            empty = max(float(a[-1].float().abs().max()) for a in got)
            log(f"flash_attention_bwd {key}: dq {e[0]:.2e} dk {e[1]:.2e} "
                f"dv {e[2]:.2e} (tol {tol}); finite {finite}, length-0 row "
                f"max {empty}")
            if not (max(e) <= tol and finite and empty == 0.0):
                raise AssertionError(f"flash backward disagrees: {key} {e}")
    detail["train_kernel_errors"] = errs

    # ---- 6. training at full width
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, use_flash=True, stem_mode="2d",
                      fused_ffn=True, loss=CTCLoss(zero_infinity=True))
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    batch = make_train_batch(np.random.RandomState(0))
    per_step = model.kernel_launches_per_step()
    log(f"train: {n_params / 1e6:.2f}M params, B=16, audio "
        f"{min(batch['inputs'][3]) / 16000:.2f}-"
        f"{max(batch['inputs'][3]) / 16000:.2f} s; launches per step derived "
        f"from the module tree: {per_step}")
    history, train_launches = counted_train_steps(trainer, batch, per_step)
    fp32 = compare_fp32_step(model, batch, loss_tol=1e-3)
    train = {"params_m": n_params / 1e6, "batch": 16, "steps": history,
             "launches_per_step": per_step, **fp32}

    # ---- 7. timings
    def step_ms(kernels: bool):
        model.set_kernels(kernels)
        trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=3,
                          warmup=0)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = [(k, *step_ms(k)) for k in (False, True, True, False)]
    model.set_kernels(True)
    for name, flag in (("kernels", True), ("plain", False)):
        ms = [r[1] for r in runs if r[0] is flag]
        train[f"step_ms_{name}_bf16"] = sum(ms) / len(ms)
        train[f"utterances_per_s_{name}"] = 16 / (sum(ms) / len(ms)) * 1e3
        train[f"peak_gib_{name}"] = max(r[2] for r in runs if r[0] is flag)
    log("train " + json.dumps({k: v for k, v in train.items()
                               if k != "steps"}))

    ffn_shapes, flash_shapes = kernel_call_shapes(trainer, batch)
    acc = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
               "ops": 0.0, "library_ms": 0.0} for k in errs}
    for (n, d, f), count in sorted(ffn_shapes.items()):
        x, g, params = ffn_inputs(n, d, f, torch.bfloat16, seed=n)

        def fwd(use_kernel):
            with torch.no_grad():
                fused_ffn(x, *params, 77, 1e-6, 0.1, True, use_kernel)

        def both(use_kernel):
            ffn_run(x, g, params, 0.1, use_kernel, seed=77)

        got = ffn_run(x, g, params, 0.1, True, seed=77)[1]
        direct = time_ffn_bwd_kernel(x, g, params, 0.1, 77, check=True)
        if max(rel_err(a, b) for a, b in zip(direct, got)) > 3e-2:
            raise AssertionError("direct backward launch disagrees with the "
                                 "wrapper's")

        # the library yardstick: the port's own unfused module on the same
        # input (the `fused_ffn=False` route: LN, Linear, swish, dropout,
        # Linear, dropout through PyTorch's library calls)
        unfused = init_params(FeedForwardModule(d, f, 0.1, fused_ffn=False),
                              torch.Generator().manual_seed(3)).to(dev).train()

        def lib(backward: bool):
            if backward:
                xl = x[None].detach().requires_grad_(True)
                unfused(xl).backward(g[None])
            else:
                with torch.no_grad():
                    unfused(x[None])

        t_f, t_fp = cuda_time_ms(lambda: fwd(True)), cuda_time_ms(
            lambda: fwd(False))
        d_f, stages = device_time_ms(lambda: fwd(True))
        h_f = host_ms(lambda: fwd(True))
        t_b, d_b = time_ffn_bwd_kernel(x, g, params, 0.1, 77)
        t_bp = cuda_time_ms(lambda: both(False)) - t_fp
        t_fl = cuda_time_ms(lambda: lib(False))
        t_bl = cuda_time_ms(lambda: lib(True)) - t_fl
        fb, fo, bb, bo = ffn_cost(n, d, f, 2)
        log(f"fused_ffn N={n} d={d} F={f} x{count}: fwd {t_f:.4f} ms "
            f"(device {d_f:.4f}, plain {t_fp:.4f}, unfused module "
            f"{t_fl:.4f}, bound {bound(fb, fo, 'bf16')[0]:.5f}); bwd "
            f"{t_b:.4f} ms (device {d_b:.4f}, plain {t_bp:.4f}, unfused "
            f"module {t_bl:.4f}, bound {bound(bb, bo, 'bf16')[0]:.5f})")
        log(f"fused_ffn_fwd N={n} d={d} device time of each stage in one "
            f"launch (torch.profiler): "
            + ", ".join(f"{nm} {ms:.4f} ms" for nm, ms in stages.items())
            + f"; whole {d_f:.4f} ms on the device, {t_f:.4f} ms per call "
            f"through the wrapper, {h_f:.4f} ms of host time to issue it")
        detail[f"ffn_N{n}_d{d}"] = {"count": count, "fwd_ms": t_f,
                                    "fwd_device_ms": d_f,
                                    "fwd_host_ms": h_f,
                                    "fwd_kernels_ms": stages,
                                    "fwd_plain_ms": t_fp,
                                    "fwd_library_ms": t_fl, "bwd_ms": t_b,
                                    "bwd_device_ms": d_b,
                                    "bwd_plain_ms": t_bp,
                                    "bwd_library_ms": t_bl}
        for key, ms, dms, pms, lms, nb, no in (
                (KERNEL_FWD, t_f, d_f, t_fp, t_fl, fb, fo),
                (KERNEL_BWD, t_b, d_b, t_bp, t_bl, bb, bo)):
            acc[key]["ms"] += count * ms
            acc[key]["device_ms"] += count * dms
            acc[key]["plain_ms"] += count * pms
            acc[key]["library_ms"] += count * lms
            acc[key]["bytes"] += count * nb
            acc[key]["ops"] += count * no
        del x, g, params, unfused
    for (t, d_model, lens), count in sorted(flash_shapes.items()):
        q, k, v, lt, scale = flash_inputs(16, t, d_model, lens,
                                          torch.bfloat16, seed=9)
        dout = torch.randn_like(v)
        out, lse = flash_attention_fwd(q, k, v, lt, scale)
        delta = (dout.float() * out.float()).sum(-1).reshape(lse.shape)
        t_both = cuda_time_ms(lambda: flash_attention_bwd(
            q, k, v, dout, lse, delta, lt, scale))
        t_plain = cuda_time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, dout, lse, delta, lt, scale))
        d_both = device_time_ms(lambda: flash_attention_bwd(
            q, k, v, dout, lse, delta, lt, scale))[0]
        t_dq, d_dq = time_single_bwd_kernel(q, k, v, dout, lse, delta, lt,
                                            scale)
        keymask = (torch.arange(t, device=dev)[None, :]
                   < lt[:, None])[:, None, None, :]
        leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]

        def sdpa(backward: bool):
            o = F.scaled_dot_product_attention(*leaves, attn_mask=keymask,
                                               scale=scale)
            if backward:
                o.backward(dout)

        t_lib = cuda_time_ms(lambda: sdpa(True)) - cuda_time_ms(
            lambda: sdpa(False))
        (dq_b, dq_o), (dkv_b, dkv_o) = flash_bwd_cost(
            4, t, q.shape[-1], v.shape[-1], lens, 2)
        log(f"flash_attention_bwd T={t} D={d_model} x{count}: dq "
            f"{t_dq:.4f} ms (device {d_dq:.4f}), dkv {t_both - t_dq:.4f} ms "
            f"(device {d_both - d_dq:.4f}), plain (both) "
            f"{t_plain:.4f}, sdpa backward {t_lib:.4f}; bounds "
            f"{bound(dq_b, dq_o, 'bf16')[0]:.5f} / "
            f"{bound(dkv_b, dkv_o, 'bf16')[0]:.5f}")
        detail[f"flash_bwd_T{t}"] = {"count": count, "dq_ms": t_dq,
                                     "dkv_ms": t_both - t_dq,
                                     "dq_device_ms": d_dq,
                                     "dkv_device_ms": d_both - d_dq,
                                     "plain_ms": t_plain, "library_ms": t_lib,
                                     "lengths": list(lens)}
        for key, ms, dms, nb, no in (
                (KERNEL_DQ, t_dq, d_dq, dq_b, dq_o),
                (KERNEL_DKV, t_both - t_dq, d_both - d_dq, dkv_b, dkv_o)):
            acc[key]["ms"] += count * ms
            acc[key]["device_ms"] += count * dms
            acc[key]["plain_ms"] += count * t_plain
            acc[key]["library_ms"] += count * t_lib
            acc[key]["bytes"] += count * nb
            acc[key]["ops"] += count * no

    if profile:
        detail["profile_train"] = profile_train_step(trainer, batch)
    detail["training"] = train

    sources = {KERNEL_FWD: ("avec_tpu_torch/csrc/ffn.cu",
                            "avec_tpu/ops/pallas_ffn.py:253"),
               KERNEL_BWD: ("avec_tpu_torch/csrc/ffn.cu",
                            "avec_tpu/ops/pallas_ffn.py:279"),
               KERNEL_DQ: ("avec_tpu_torch/csrc/flash_attention_bwd.cu",
                           "avec_tpu/ops/pallas_attention.py:316"),
               KERNEL_DKV: ("avec_tpu_torch/csrc/flash_attention_bwd.cu",
                            "avec_tpu/ops/pallas_attention.py:339")}
    entries = []
    for key, (src, replaces) in sources.items():
        b_ms, b_by = bound(acc[key]["bytes"], acc[key]["ops"], "bf16")
        entries.append({
            "name": key, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train_launches[key], "max_abs_err": abs_errs[key],
            "ms": acc[key]["ms"], "device_ms": acc[key]["device_ms"],
            "plain_ms": acc[key]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": acc[key]["library_ms"]})
    return entries, trainer, batch


def att_inputs(b, t, d, dtype, seed):
    """x, a cotangent and the attention module's twelve parameters in the
    port's layout (weights (out, in)), seeded."""
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    g = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    params = [1.0 + 0.1 * torch.randn(d, generator=gen),
              0.1 * torch.randn(d, generator=gen)]
    for _ in range(5):
        params += [torch.randn(d, d, generator=gen) / d ** 0.5,
                   0.1 * torch.randn(d, generator=gen)]
    return x, g, [p.to(dev) for p in params]


def att_run(x, g, params, heads, lens, drop, residual, use_kernel, seed=4321):
    """y and the gradients of x and the twelve parameters."""
    from avec_tpu_torch.ops.attention_module import fused_attention_module_3d

    leaves = [a.detach().requires_grad_(True) for a in [x] + params]
    y = fused_attention_module_3d(
        leaves[0], *leaves[1:], num_heads=heads, lengths=lens, seed=seed,
        drop_rate=drop, deterministic=False, residual=residual,
        use_kernel=use_kernel)
    y.backward(g)
    return y.detach(), [a.grad for a in leaves]


def att_cost(b, t, d, heads, es):
    """(forward bytes, forward ops, backward bytes, backward ops) of the
    attention module with n = b t rows: x read and y written once, the fp32
    parameters (2 d + 5 (d^2 + d)) and the (t, d) angle table read once, the
    lengths; in the backward x, g and dx, the parameters read and their
    gradients written. Forward products: q, k, v and the output projection
    (8 n d^2), the rel-pos projection of q (2 n d^2), q k^T and att v
    (4 b t^2 d), the rel-pos score term contracted over d for every head
    (2 heads b t^2 d). The backward recomputes all but the output projection
    and adds dWo and the merged heads' cotangent (4 n d^2), dO V^T, dv, ds k
    and dk (8 b t^2 d), ds against the angle table (2 heads b t^2 d), the
    rel-pos projection's two gradients (4 n d^2), dWq/dWk/dWv and dh
    (12 n d^2). Every sequence is computed at full T whatever its length: the
    mask is additive."""
    n, pbytes = b * t, 4 * (2 * d + 5 * (d * d + d))
    table = t * d * es + 4 * b
    sq = float(b) * t * t * d
    f_ops = 10.0 * n * d * d + sq * (4 + 2 * heads)
    b_ops = 28.0 * n * d * d + sq * (12 + 4 * heads)
    return (2 * n * d * es + pbytes + table, f_ops,
            3 * n * d * es + 2 * pbytes + table, b_ops)


def time_att_bwd_kernel(x, g, params, heads, lens, drop, seed):
    """Time and device time of one fused-attention backward call alone (all its stages),
    through the library's C entry point with the wrapper's own arguments and
    preallocated scratch and gradient buffers; this call is outside any
    count."""
    from avec_tpu_torch.ops import _cuda, attention_module as am
    from avec_tpu_torch.ops.ffn import _threshold

    b, t, d = x.shape
    _, bwd, size = am._lib()
    thr, inv_keep = _threshold(1.0 - drop)
    tab = am._interleaved_table(t, d, x.dtype, x.device)
    scratch = torch.empty(size(b, t, d, heads, 1,
                               int(x.dtype == torch.bfloat16)),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.zeros_like(p) for p in params]
    pp, gp = am._pointers(params), am._pointers(grads)
    args = (x.data_ptr(), g.data_ptr(), tab.data_ptr(), lens.data_ptr(), pp,
            dx.data_ptr(), gp, scratch.data_ptr(), b, t, d, heads, 1e-6,
            1.0 / math.sqrt(d // heads), 0, 1, seed, thr, inv_keep,
            int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))

    def launch():
        _cuda.check(bwd(*args), "fused_att_bwd")

    return cuda_time_ms(launch), device_time_ms(launch)[0]


def attention_call_shapes(trainer, batch):
    """One forward in training mode with hooks: how often each fused
    attention shape (T, d, heads, lengths) occurs in a step."""
    from avec_tpu_torch.models.conformer import AttentionModule

    shapes, hooks = {}, []

    def on_att(mod, args, kwargs):
        x, lengths = args[0], kwargs.get("lengths")
        key = (x.shape[1], x.shape[2], mod.attention.num_heads,
               tuple(int(v) for v in lengths.tolist()))
        shapes[key] = shapes.get(key, 0) + 1

    for m in trainer.model.modules():
        if isinstance(m, AttentionModule) and m.fused_eligible():
            hooks.append(m.register_forward_pre_hook(on_att,
                                                     with_kwargs=True))
    inputs, _ = trainer._to_device(batch)
    with torch.no_grad():
        trainer.model.encoder(*inputs)
    for hk in hooks:
        hk.remove()
    return shapes


def fused_phases(detail, profile: bool, trainer2, batch):
    """Phases 8-11: the fused attention module (K2, K2b) and the train-mode
    stem against their plain versions, the train path that runs them at full
    width, and its times beside the flash path's (`trainer2`). Returns the
    two attention kernels' entries and the stem kernel's launch count on this
    path."""
    from avec_tpu_torch.models.conformer import AttentionModule
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.attention_module import (
        KERNEL_BWD, KERNEL_FWD, fused_attention_module_3d)
    from avec_tpu_torch.ops.ffn import dropout_mask
    from avec_tpu_torch.ops.layers import init_params
    from avec_tpu_torch.ops.stem import KERNEL as KERNEL_STEM
    from avec_tpu_torch.ops.stem import (bn_relu_pool, bn_relu_pool_reference,
                                         fused_stem_train)
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    dev = torch.device("cuda")
    errs = {KERNEL_FWD: {}, KERNEL_BWD: {}}
    abs_errs = {KERNEL_FWD: 0.0, KERNEL_BWD: 0.0}

    # ---- 8. K2 / K2b against the plain version at both shape families
    for t, d in ((151, 256), (76, 360)):
        lens = torch.tensor(RAGGED_TRAIN_LENGTHS[t], dtype=torch.int32,
                            device=dev)
        for dtype, tol, wtol in ((torch.float32, 1e-4, 5e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = att_inputs(16, t, d, dtype, seed=t)
            for drop, residual in ((0.0, False), (0.0, True), (0.1, False),
                                   (0.1, True)):
                y, grads = att_run(x, g, params, 4, lens, drop, residual,
                                   True)
                torch.cuda.synchronize()
                want_y, want = att_run(x, g, params, 4, lens, drop, residual,
                                       False)
                key = (f"T{t}_d{d}_{str(dtype)[6:]}_drop{drop}_"
                       f"res{int(residual)}")
                gmax = max(float(a.abs().max()) for a in want[1:])
                e_fwd = rel_err(y, want_y)
                e_bwd = {nm: rel_err(a, b)
                         for nm, a, b in zip(ATT_LEAVES, grads, want)
                         if float(b.float().abs().max()) > 1e-6 * gmax}
                errs[KERNEL_FWD][key] = e_fwd
                errs[KERNEL_BWD][key] = e_bwd
                if dtype == torch.float32:
                    abs_errs[KERNEL_FWD] = max(abs_errs[KERNEL_FWD],
                                               max_abs(y, want_y))
                    abs_errs[KERNEL_BWD] = max(
                        abs_errs[KERNEL_BWD],
                        *(max_abs(a, b) for a, b in zip(grads, want)))
                if drop:
                    # exactly the hash mask's entries are dropped, on both
                    # sides: there y is 0, or x with the residual
                    base = x if residual else torch.zeros_like(x)
                    dropped = dropout_mask(4321, 16 * t, d, 1, 1.0 - drop, dev,
                                           tile_rows=t).reshape(16, t, d) == 0
                    kept_equal = float(((y == base) & ~dropped).float().mean())
                    if not (bool((y[dropped] == base[dropped]).all())
                            and bool((want_y[dropped] == base[dropped]).all())
                            and kept_equal < 5e-3):
                        raise AssertionError(f"dropout masks differ: {key}")
                worst_w = max(v for nm, v in e_bwd.items() if nm != "x")
                log(f"fused_att {key}: y {e_fwd:.2e} (tol {tol}) dx "
                    f"{e_bwd['x']:.2e} params {worst_w:.2e} (tol {wtol}); "
                    + " ".join(f"{nm} {v:.1e}" for nm, v in e_bwd.items()
                               if nm != "x"))
                x_tol = wtol if dtype == torch.float32 else tol
                if not (e_fwd <= tol and e_bwd["x"] <= x_tol
                        and worst_w <= wtol):
                    raise AssertionError(f"attention kernels disagree: {key} "
                                         f"{e_fwd} {e_bwd}")
            del x, g, params
    detail["att_kernel_errors"] = errs

    # ---- 9. the train-mode stem on the card: kernel route vs plain route
    gen = torch.Generator().manual_seed(11)
    video = torch.rand(16, 151, 88, 88, 1, generator=gen).to(dev)
    cot = torch.randn(16 * 151, 22, 22, 64, generator=gen).to(dev)
    conv_w = (torch.randn(64, 1, 5, 7, 7, generator=gen) / 245 ** 0.5).to(dev)
    vecs = [(0.1 * torch.randn(64, generator=gen) + shift).to(dev)
            for shift in (0.0, 1.0, 0.0)]           # conv bias, BN scale, bias
    stem_errs = {}
    for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-4),
                             (torch.bfloat16, 0.0, 1e-2)):
        res = []
        for use_kernel in (True, False):
            leaves = [a.detach().clone().requires_grad_(True)
                      for a in [conv_w] + vecs]
            n0 = _cuda.launches[KERNEL_STEM]
            pooled, mean, var = fused_stem_train(video.to(dtype), *leaves,
                                                 1e-5, use_kernel)
            pooled.backward(cot.to(dtype))
            torch.cuda.synchronize()
            if _cuda.launches[KERNEL_STEM] - n0 != int(use_kernel):
                raise AssertionError("stem route launched the wrong kernel "
                                     "count")
            res.append((pooled.detach(), mean, var,
                        [a.grad for a in leaves]))
            del pooled, leaves
        (pk, mk, vk, gk), (pp, mp, vp, gp) = res
        e = {"pooled": max_abs(pk, pp), "mean": max_abs(mk, mp),
             "var": max_abs(vk, vp), "conv_w": rel_err(gk[0], gp[0]),
             "bn_scale": rel_err(gk[2], gp[2]),
             "bn_bias": rel_err(gk[3], gp[3]),
             "conv_bias_grad_max": float(gk[1].abs().max())}
        stem_errs[str(dtype)[6:]] = e
        log(f"fused_stem_train {str(dtype)[6:]} kernel vs plain route: "
            + json.dumps(e) + f" (tol {tol} forward, {gtol} gradients)")
        if not (e["pooled"] <= tol and e["mean"] <= 1e-5 and e["var"] <= 1e-5
                and max(e["conv_w"], e["bn_scale"], e["bn_bias"]) <= gtol
                and e["conv_bias_grad_max"] == 0.0
                and float(gp[1].abs().max()) == 0.0):
            raise AssertionError(f"train-mode stem routes disagree: {e}")
        del res, pk, pp, gk, gp
    del video, cot
    # the stem kernel at the training shape: 16 x 151 frames, bf16
    y = torch.randn(16 * 151, 44, 44, 64, generator=gen).to(dev,
                                                            torch.bfloat16)
    a5, b5 = vecs[1].contiguous(), vecs[2].contiguous()
    s_ms = cuda_time_ms(lambda: bn_relu_pool(y, a5, b5))
    s_dev = device_time_ms(lambda: bn_relu_pool(y, a5, b5))[0]
    s_plain = cuda_time_ms(lambda: bn_relu_pool_reference(y, a5, b5))
    s_bytes = y.numel() * 2 + (y.numel() // 4) * 2 + 2 * 64 * 4
    s_bound = bound(s_bytes, 3.0 * y.numel(), "bf16")[0]
    log(f"bn_relu_pool N={y.shape[0]} (training shape): {s_ms:.4f} ms "
        f"(device {s_dev:.4f}), plain {s_plain:.4f}, bound {s_bound:.5f}")
    detail["stem_train"] = {"ms": s_ms, "device_ms": s_dev,
                            "plain_ms": s_plain,
                            "bytes": s_bytes, "bound_ms": s_bound}
    del y
    torch.cuda.empty_cache()
    detail["stem_train_errors"] = stem_errs

    # ---- 10. the fused-attention train path at full width
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, use_flash=False, stem_mode="pallas",
                      fused_att=True, fused_ffn=True,
                      loss=CTCLoss(zero_infinity=True))
    model = trainer.model
    per_step = model.kernel_launches_per_step()
    log(f"train (fused attention, stem pallas, no flash): launches per step "
        f"derived from the module tree: {per_step}")
    want_steps = {"fused_att_fwd": 19, "fused_att_bwd": 19,
                  "fused_ffn_fwd": 48, "fused_ffn_bwd": 48, "bn_relu_pool": 1}
    if per_step != want_steps:
        raise AssertionError(f"launches per step {per_step} != {want_steps}")
    history, launches = counted_train_steps(trainer, batch, per_step)
    fp32 = compare_fp32_step(model, batch, loss_tol=1e-5)
    train = {"steps": history, "launches_per_step": per_step, **fp32}

    # ---- 11. timings: this path beside the flash path, interleaved
    def step_ms(tr):
        tr.model.set_kernels(True)
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: tr.train_step(batch), iters=3, warmup=0)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = [(name, *step_ms(tr)) for name, tr in (
        ("flash", trainer2), ("fused_att", trainer), ("fused_att", trainer),
        ("flash", trainer2))]
    for name in ("fused_att", "flash"):
        ms = [r[1] for r in runs if r[0] == name]
        train[f"step_ms_{name}_path_bf16"] = sum(ms) / len(ms)
        train[f"utterances_per_s_{name}_path"] = 16 / (sum(ms) / len(ms)) * 1e3
        train[f"peak_gib_{name}_path"] = max(r[2] for r in runs
                                             if r[0] == name)
    train["step_ms_runs_in_order"] = [[r[0], r[1]] for r in runs]
    log("train (fused attention path beside the flash path) "
        + json.dumps({k: v for k, v in train.items() if k != "steps"}))

    acc = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bytes": 0, "ops": 0.0} for k in errs}
    for (t, d, heads, lens), count in sorted(
            attention_call_shapes(trainer, batch).items()):
        x, g, params = att_inputs(16, t, d, torch.bfloat16, seed=t + 1)
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)

        def fwd(use_kernel):
            with torch.no_grad():
                fused_attention_module_3d(
                    x, *params, num_heads=heads, lengths=lt, seed=77,
                    drop_rate=0.1, deterministic=False, residual=False,
                    use_kernel=use_kernel)

        def both(use_kernel):
            att_run(x, g, params, heads, lt, 0.1, False, use_kernel, seed=77)

        # the library yardstick: the port's own unfused module on the same
        # input (LN, three Linear, factorized scores, softmax, Linear,
        # dropout through PyTorch's library calls)
        unfused = init_params(
            AttentionModule(d, {"class": "RelPos1dMultiHeadAttention",
                                "params": {"num_heads": heads}}, 0.1,
                            fused_att=False),
            torch.Generator().manual_seed(3)).to(dev).train()
        mask = (torch.arange(t, device=dev)[None, :]
                < lt[:, None])[:, None, None, :]

        def lib(backward: bool):
            if backward:
                unfused(x.detach().requires_grad_(True), mask=mask).backward(g)
            else:
                with torch.no_grad():
                    unfused(x, mask=mask)

        t_f, t_fp = cuda_time_ms(lambda: fwd(True)), cuda_time_ms(
            lambda: fwd(False))
        d_f = device_time_ms(lambda: fwd(True))[0]
        t_b, d_b = time_att_bwd_kernel(x, g, params, heads, lt, 0.1, 77)
        t_bp = cuda_time_ms(lambda: both(False)) - t_fp
        t_fl = cuda_time_ms(lambda: lib(False))
        t_bl = cuda_time_ms(lambda: lib(True)) - t_fl
        fb, fo, bb, bo = att_cost(16, t, d, heads, 2)
        log(f"fused_att T={t} d={d} H={heads} x{count}: fwd {t_f:.4f} ms "
            f"(device {d_f:.4f}, plain {t_fp:.4f}, unfused module "
            f"{t_fl:.4f}, bound {bound(fb, fo, 'bf16')[0]:.5f}); bwd "
            f"{t_b:.4f} ms (device {d_b:.4f}, plain "
            f"{t_bp:.4f}, unfused module {t_bl:.4f}, bound "
            f"{bound(bb, bo, 'bf16')[0]:.5f}); bytes {fb} / {bb}, "
            f"operations {fo:.4g} / {bo:.4g}")
        detail[f"att_T{t}_d{d}"] = {
            "count": count, "fwd_ms": t_f, "fwd_device_ms": d_f,
            "fwd_plain_ms": t_fp, "fwd_library_ms": t_fl, "bwd_ms": t_b,
            "bwd_device_ms": d_b, "bwd_plain_ms": t_bp,
            "bwd_library_ms": t_bl, "fwd_bytes": fb, "fwd_ops": fo,
            "bwd_bytes": bb, "bwd_ops": bo, "lengths": list(lens)}
        for key, ms, dms, pms, lms, nb, no in (
                (KERNEL_FWD, t_f, d_f, t_fp, t_fl, fb, fo),
                (KERNEL_BWD, t_b, d_b, t_bp, t_bl, bb, bo)):
            acc[key]["ms"] += count * ms
            acc[key]["device_ms"] += count * dms
            acc[key]["plain_ms"] += count * pms
            acc[key]["library_ms"] += count * lms
            acc[key]["bytes"] += count * nb
            acc[key]["ops"] += count * no
        del x, g, params, unfused

    if profile:
        detail["profile_train_fused_att"] = profile_train_step(trainer, batch)
    detail["training_fused_att"] = train

    replaces = {KERNEL_FWD: "avec_tpu/ops/pallas_attention_module.py:316",
                KERNEL_BWD: "avec_tpu/ops/pallas_attention_module.py:345"}
    entries = []
    for key in (KERNEL_FWD, KERNEL_BWD):
        b_ms, b_by = bound(acc[key]["bytes"], acc[key]["ops"], "bf16")
        entries.append({
            "name": key, "route": "cuda",
            "source": "avec_tpu_torch/csrc/attention_module.cu",
            "replaces": replaces[key], "launches": launches[key],
            "max_abs_err": abs_errs[key], "ms": acc[key]["ms"],
            "device_ms": acc[key]["device_ms"],
            "plain_ms": acc[key]["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": acc[key]["library_ms"]})
    return entries, launches[KERNEL_STEM], trainer


CONV_SHAPES = ((16, 301, 180, 15), (16, 151, 256, 15), (16, 76, 360, 15))


# what K3b-2 writes: dx and the gradients of LN, pw1 and the depthwise taps
BWD2_LEAVES = ("x", "ln_w", "ln_b", "pw1_w", "pw1_b", "dw_w")


def conv_inputs(b, t, d, k, dtype, seed):
    """x, a cotangent and the convolution module's ten parameters in the
    port's Conv layout (E = E' = d), seeded."""
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    g = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    vec = lambda: 0.1 * torch.randn(d, generator=gen)
    u = lambda shape, fan: ((2 * torch.rand(shape, generator=gen) - 1)
                            / fan ** 0.5)
    params = [1.0 + vec(), vec(), u((2 * d, d, 1), d), u((2 * d,), d),
              u((d, 1, k), k), u((d,), k), 1.0 + vec(), vec(), u((d, d, 1), d),
              u((d,), d)]
    return x, g, [p.to(dev) for p in params]


def conv_run(x, g, params, padding, drop, use_kernel, seed=4321, dp=False):
    """(y, mean, var) and the gradients of x and the ten parameters; with
    `dp`, through the K3dp form on this rank's shard x (global statistics,
    partial parameter gradients)."""
    from avec_tpu_torch.ops import conv_module as cm

    fn = cm.fused_conv_module_3d_dp if dp else cm.fused_conv_module_3d
    leaves = [a.detach().requires_grad_(True) for a in [x] + params]
    y, mean, var = fn(
        leaves[0], *leaves[1:], seed=seed, padding=padding, drop_rate=drop,
        deterministic=False, use_kernel=use_kernel)
    y.backward(g)
    return [y.detach(), mean, var], [a.grad for a in leaves]


def conv_cost(b, t, d, e, eo, k, es):
    """Bytes and operations of each of the four passes, keyed by kernel name.
    Bytes: each input read once (x, g, the fp32 parameters a pass reads, the
    (E,) statistics) and each output written once. Operations: what the pass
    adds to the module's work; the recomputed forward is the kernels' own
    work, not the bound's. K3-stats: pw1, both halves (4 n d E), and the
    depthwise taps (2 n E k); K3-fwd: pw2 (2 n E E'); K3b-1: dW2 and
    ds = g W2 (4 n E E'); K3b-2: dW1 and dh, both halves (8 n d E), and the
    depthwise data and tap gradients (4 n E k)."""
    from avec_tpu_torch.ops.conv_module import KERNELS

    n = b * t
    pre = 4 * (2 * d + 2 * e * d + 2 * e + k * e + e)
    full = pre + 4 * (2 * e + eo * e + eo)
    cost = ((n * d * es + pre + 8 * e, 4.0 * n * d * e + 2.0 * n * e * k),
            (n * d * es + full + 8 * e + n * eo * es, 2.0 * n * e * eo),
            (n * (d + eo) * es + full + 8 * e + 4 * (eo * e + eo + 2 * e),
             4.0 * n * e * eo),
            (n * (2 * d + eo) * es + full + 16 * e
             + 4 * (2 * d + 2 * e * d + 2 * e + k * e),
             8.0 * n * d * e + 4.0 * n * e * k))
    return dict(zip(KERNELS, cost))


def time_conv_passes(x, g, params, drop, seed):
    """ms per launch of each of the four passes alone, through the library's
    C entry points with the wrapper's own arguments, preallocated outputs and
    scratch, and this input's batch statistics (the accumulators are not
    re-zeroed: timing only). Outside any count. Beside each pass's time
    (`cuda_time_ms`): under "<name>_device" and "<name>_kernels" its device
    time, whole and by kernel (`device_time_ms`), and under "<name>_host"
    the host's time to issue it (`host_ms`)."""
    from avec_tpu_torch.ops import _cuda, conv_module as cm

    k = params[4].shape[-1]
    call = cm._Launch(x, params, seed, cm.pad_lo_for("same", k), 1e-6, drop)
    b, t, d, e, eo, _ = call.dims
    n = b * t
    s1, s2 = call.stats()
    mean, _, rstd = cm.batch_stats(s1, s2, n, 1e-5)
    zeros = lambda *shape: torch.zeros(shape, device=x.device)
    keep = []                     # the buffers behind the pointers below

    def ptr(a):
        keep.append(a)
        return a.data_ptr()

    grads = [zeros(d), zeros(d), zeros(2 * e, d), zeros(2 * e), zeros(e, k)]
    args = (
        (ptr(x), call.ptrs, ptr(zeros(e)), ptr(zeros(e))),
        (ptr(x), call.ptrs, ptr(mean), ptr(rstd),
         ptr(torch.empty(b, t, eo, dtype=x.dtype, device=x.device))),
        (ptr(x), ptr(g), call.ptrs, ptr(mean), ptr(rstd), ptr(zeros(eo, e)),
         ptr(zeros(eo)), ptr(zeros(e)), ptr(zeros(e))),
        (ptr(x), ptr(g), call.ptrs, ptr(mean), ptr(rstd), ptr(zeros(e)),
         ptr(zeros(e)), ptr(torch.empty_like(x)), cm._pointers(grads)))
    times = {}
    for stage, name in enumerate(cm.KERNELS):
        fn, a = (call.fns[stage],
                 args[stage] + (ptr(call.scratch(stage)),) + call.tail[:-1])

        def launch():
            _cuda.check(fn(*a, _cuda.stream_ptr(x)), name)

        times[name] = cuda_time_ms(launch)
        times[name + "_device"], times[name + "_kernels"] = device_time_ms(
            launch)
        times[name + "_host"] = host_ms(launch)
    return times


def conv_call_shapes(trainer, batch):
    """One forward in training mode with hooks: how often each fused
    convolution shape (B, T, d, E, k) occurs in a step."""
    from avec_tpu_torch.models.conformer import ConvolutionModule

    shapes, hooks = {}, []

    def on_conv(mod, args):
        x = args[0]
        key = (x.shape[0], x.shape[1], x.shape[2],
               mod.layers["4"].weight.shape[0],
               mod.layers["3"].weight.shape[-1])
        shapes[key] = shapes.get(key, 0) + 1

    for m in trainer.model.modules():
        if isinstance(m, ConvolutionModule) and m.fused_eligible():
            hooks.append(m.register_forward_pre_hook(on_conv))
    inputs, _ = trainer._to_device(batch)
    with torch.no_grad():
        trainer.model.encoder(*inputs)
    for hk in hooks:
        hk.remove()
    return shapes


def conv_phases(detail, profile: bool, trainer_att, batch):
    """Phases 12-14: K3 / K3b against the plain stages, the train path that
    runs every training kernel at full width, and its times beside phase
    10's path (`trainer_att`). Returns the four conv kernels' entries and
    the step's fused convolution shapes {(B, T, d, E, k): count}."""
    from avec_tpu_torch.models.conformer import ConvolutionModule
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.ops.ffn import dropout_mask
    from avec_tpu_torch.ops.layers import init_params
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    dev = torch.device("cuda")
    names = ("x",) + cm.PARAM_NAMES
    errs, abs_errs = {}, {name: 0.0 for name in cm.KERNELS}
    # which outputs each pass produces (for the fp32 max abs of the kernels
    # line): stats the batch statistics, fwd y, bwd1 the pw2 and BN
    # gradients, bwd2 dx and the rest
    owner = {"mean": cm.KERNEL_STATS, "var": cm.KERNEL_STATS,
             "y": cm.KERNEL_FWD, "pw2_w": cm.KERNEL_BWD1,
             "pw2_b": cm.KERNEL_BWD1, "bn_w": cm.KERNEL_BWD1,
             "bn_b": cm.KERNEL_BWD1}

    # ---- 12. K3 / K3b against the plain stages at the three families
    for b, t, d, k in CONV_SHAPES:
        for dtype, tol, wtol in ((torch.float32, 1e-4, 5e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = conv_inputs(b, t, d, k, dtype, seed=d)
            for padding, drop in (("same", 0.0), ("same", 0.1),
                                  ("causal", 0.0), ("causal", 0.1)):
                outs, grads = conv_run(x, g, params, padding, drop, True)
                torch.cuda.synchronize()
                want_outs, want = conv_run(x, g, params, padding, drop, False)
                key = f"T{t}_d{d}_{str(dtype)[6:]}_{padding}_drop{drop}"
                e = {nm: rel_err(a, w) for nm, a, w in zip(
                    ("y", "mean", "var"), outs, want_outs)}
                e.update({nm: rel_err(a, w) for nm, a, w in zip(names, grads,
                                                                want)
                          if nm != "dw_b"})
                e["dw_b_grad_max"] = float(grads[names.index("dw_b")].abs()
                                           .max())
                errs[key] = e
                if dtype == torch.float32:
                    pairs = list(zip(("y", "mean", "var"), outs, want_outs))
                    pairs += list(zip(names, grads, want))
                    for nm, a, w in pairs:
                        kern = owner.get(nm, cm.KERNEL_BWD2)
                        abs_errs[kern] = max(abs_errs[kern], max_abs(a, w))
                if drop:
                    dropped = dropout_mask(4321, b * t, d, 1, 1.0 - drop, dev,
                                           tile_rows=t).reshape(b, t, d) == 0
                    for y in (outs[0], want_outs[0]):
                        kept_zero = float((y[~dropped] == 0).float().mean())
                        if not (bool((y[dropped] == 0).all())
                                and kept_zero < 5e-3):
                            raise AssertionError(
                                f"dropout masks differ: {key}")
                fwd_err = max(e["y"], e["mean"], e["var"])
                worst_w = max(v for nm, v in e.items()
                              if nm in cm.PARAM_NAMES)
                x_tol = wtol if dtype == torch.float32 else tol
                log(f"fused_conv {key}: y {e['y']:.2e} mean {e['mean']:.2e} "
                    f"var {e['var']:.2e} (tol {tol}) dx {e['x']:.2e} (tol "
                    f"{x_tol}) params {worst_w:.2e} (tol {wtol}); "
                    + " ".join(f"{nm} {v:.1e}" for nm, v in e.items()
                               if nm in cm.PARAM_NAMES)
                    + f"; dw_b grad max {e['dw_b_grad_max']}")
                if not (fwd_err <= tol and e["x"] <= x_tol
                        and worst_w <= wtol and e["dw_b_grad_max"] == 0.0
                        and float(want[names.index("dw_b")].abs().max())
                        == 0.0):
                    raise AssertionError(f"conv kernels disagree: {key} {e}")
            if dtype == torch.bfloat16:
                # K3b-2 sums without atomics: from the same inputs (K3b-1's
                # r1, r2 keep their atomics), dx and its five gradients
                call = cm._Launch(x, params, 4321, cm.pad_lo_for("same", k),
                                  1e-6, 0.1)
                mean, _, rstd = cm.batch_stats(*call.stats(), b * t, 1e-5)
                _, _, r1, r2 = call.bwd1(g, mean, rstd)
                reruns = [call.bwd2(g, mean, rstd, r1 / (b * t), r2 / (b * t))
                          for _ in range(2)]
                same = all(torch.equal(u, v) for u, v in zip(*reruns))
                log(f"fused_conv T{t}_d{d}_bfloat16_same_drop0.1: K3b-2's dx "
                    f"and the gradients of {', '.join(BWD2_LEAVES[1:])} "
                    f"bit-identical over two calls: {same}")
                if not same:
                    raise AssertionError(f"bf16 K3b-2 reruns differ: T{t}")
            del x, g, params
    detail["conv_kernel_errors"] = errs

    # ---- 13. the path through every training kernel at full width
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, use_flash=False, stem_mode="pallas",
                      fused_att=True, fused_conv=True, fused_ffn=True,
                      loss=CTCLoss(zero_infinity=True))
    model = trainer.model
    per_step = model.kernel_launches_per_step()
    log(f"train (fused conv, fused attention, stem pallas, no flash): "
        f"launches per step derived from the module tree: {per_step}")
    want_steps = {"fused_att_fwd": 19, "fused_att_bwd": 19,
                  "fused_ffn_fwd": 48, "fused_ffn_bwd": 48, "bn_relu_pool": 1,
                  **{name: 21 for name in cm.KERNELS}}
    if per_step != want_steps:
        raise AssertionError(f"launches per step {per_step} != {want_steps}")
    history, launches = counted_train_steps(trainer, batch, per_step)
    fp32 = compare_fp32_step(model, batch, loss_tol=1e-5)
    train = {"steps": history, "launches_per_step": per_step, **fp32}

    # ---- 14. times: the four passes, then this path beside phase 10's
    acc = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bytes": 0, "ops": 0.0}
           for name in cm.KERNELS}
    shapes = conv_call_shapes(trainer, batch)
    for (b, t, d, e, k), count in sorted(shapes.items()):
        x, g, params = conv_inputs(b, t, d, k, torch.bfloat16, seed=t + 2)
        pad_lo = cm.pad_lo_for("same", k)
        times = time_conv_passes(x, g, params, 0.1, 77)
        s1, s2 = cm.conv_stats_reference(x, params, pad_lo)
        mean, _, rstd = cm.batch_stats(s1, s2, b * t, 1e-5)
        _, _, r1, r2 = cm.conv_bwd1_reference(x, g, params, mean, rstd, 77,
                                              pad_lo, drop_rate=0.1)
        rn1, rn2 = r1 / (b * t), r2 / (b * t)
        plain = {
            cm.KERNEL_STATS: lambda: cm.conv_stats_reference(x, params,
                                                             pad_lo),
            cm.KERNEL_FWD: lambda: cm.conv_fwd_reference(
                x, params, mean, rstd, 77, pad_lo, drop_rate=0.1),
            cm.KERNEL_BWD1: lambda: cm.conv_bwd1_reference(
                x, g, params, mean, rstd, 77, pad_lo, drop_rate=0.1),
            cm.KERNEL_BWD2: lambda: cm.conv_bwd2_reference(
                x, g, params, mean, rstd, rn1, rn2, 77, pad_lo,
                drop_rate=0.1)}
        plain_ms = {name: cuda_time_ms(fn, iters=5) for name, fn in
                    plain.items()}
        # the library yardstick: the port's own unfused module on the same
        # input (LN, F.conv1d, GLU, depthwise F.conv1d, BatchNorm, swish,
        # F.conv1d, dropout through PyTorch's library calls)
        unfused = init_params(ConvolutionModule(d, e, 1, k, "same", 0.1,
                                                fused_conv=False),
                              torch.Generator().manual_seed(3)).to(dev).train()

        def lib(backward: bool):
            if backward:
                unfused(x.detach().requires_grad_(True)).backward(g)
            else:
                with torch.no_grad():
                    unfused(x)

        t_fl = cuda_time_ms(lambda: lib(False))
        t_bl = cuda_time_ms(lambda: lib(True)) - t_fl
        lib_ms = {cm.KERNEL_FWD: t_fl, cm.KERNEL_BWD2: t_bl}
        cost = conv_cost(b, t, d, e, e, k, 2)
        row = {"count": count}
        for name in cm.KERNELS:
            nb, no = cost[name]
            b_ms = bound(nb, no, "bf16")[0]
            row[name] = {"ms": times[name],
                         "device_ms": times[name + "_device"],
                         "host_ms": times[name + "_host"],
                         "kernels_ms": times[name + "_kernels"],
                         "plain_ms": plain_ms[name], "bound_ms": b_ms,
                         "bytes": nb, "ops": no}
            acc[name]["ms"] += count * times[name]
            acc[name]["device_ms"] += count * times[name + "_device"]
            acc[name]["plain_ms"] += count * plain_ms[name]
            acc[name]["library_ms"] += count * lib_ms.get(name, 0.0)
            acc[name]["bytes"] += count * nb
            acc[name]["ops"] += count * no
        row["unfused_fwd_ms"], row["unfused_bwd_ms"] = t_fl, t_bl
        detail[f"conv_T{t}_d{d}"] = row
        log(f"fused_conv_bwd2 T={t} d={d} device time of each stage in one "
            f"launch (torch.profiler): "
            + ", ".join(f"{nm} {ms:.4f} ms" for nm, ms in
                        times[cm.KERNEL_BWD2 + "_kernels"].items())
            + f"; whole pass {times[cm.KERNEL_BWD2 + '_device']:.4f} ms on "
            f"the device, {times[cm.KERNEL_BWD2]:.4f} ms per direct launch, "
            f"{times[cm.KERNEL_BWD2 + '_host']:.4f} ms of host time to issue "
            f"it")
        log(f"fused_conv T={t} d={d} k={k} x{count}: "
            + "; ".join(f"{name[11:]} {times[name]:.4f} ms (device "
                        f"{times[name + '_device']:.4f}, host issue "
                        f"{times[name + '_host']:.4f}, plain "
                        f"{plain_ms[name]:.4f}, bound "
                        f"{row[name]['bound_ms']:.5f}, bytes {cost[name][0]}, "
                        f"operations {cost[name][1]:.4g})"
                        for name in cm.KERNELS)
            + f"; unfused module fwd {t_fl:.4f} ms, bwd {t_bl:.4f} ms")
        del x, g, params, unfused

    def step_ms(tr):
        tr.model.set_kernels(True)
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: tr.train_step(batch), iters=3, warmup=0)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = [(name, *step_ms(tr)) for name, tr in (
        ("fused_att", trainer_att), ("fused_conv", trainer),
        ("fused_conv", trainer), ("fused_att", trainer_att))]
    for name in ("fused_conv", "fused_att"):
        ms = [r[1] for r in runs if r[0] == name]
        train[f"step_ms_{name}_path_bf16"] = sum(ms) / len(ms)
        train[f"utterances_per_s_{name}_path"] = 16 / (sum(ms) / len(ms)) * 1e3
        train[f"peak_gib_{name}_path"] = max(r[2] for r in runs
                                             if r[0] == name)
    train["step_ms_runs_in_order"] = [[r[0], r[1]] for r in runs]
    log("train (fused conv path beside the fused attention path) "
        + json.dumps({k: v for k, v in train.items() if k != "steps"}))
    if profile:
        detail["profile_train_fused_conv"] = profile_train_step(trainer, batch)
    detail["training_fused_conv"] = train

    replaces = dict(zip(cm.KERNELS, (
        "avec_tpu/ops/pallas_conv_module.py:342",
        "avec_tpu/ops/pallas_conv_module.py:358",
        "avec_tpu/ops/pallas_conv_module.py:393",
        "avec_tpu/ops/pallas_conv_module.py:421")))
    entries = []
    for name in cm.KERNELS:
        b_ms, b_by = bound(acc[name]["bytes"], acc[name]["ops"], "bf16")
        log(f"{name} per step: {acc[name]['ms']:.4f} ms (device "
            f"{acc[name]['device_ms']:.4f}), bound {b_ms:.5f} ({b_by}), "
            f"plain {acc[name]['plain_ms']:.4f}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "avec_tpu_torch/csrc/conv_module.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": abs_errs[name], "ms": acc[name]["ms"],
            "device_ms": acc[name]["device_ms"],
            "plain_ms": acc[name]["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by,
            # the unfused module's forward stands beside the forward pair,
            # its backward beside the backward pair
            "library_ms": (acc[name]["library_ms"] if name in (
                cm.KERNEL_FWD, cm.KERNEL_BWD2) else None)})
    return entries, shapes


DP_RANKS = 2                       # gloo ranks sharing the one card
DP_ROUTE = dict(use_flash=False, stem_mode="2d", fused_att=True,
                fused_conv=True, fused_ffn=True)
DP_WANT_STEPS = {"fused_att_fwd": 19, "fused_att_bwd": 19,
                 "fused_ffn_fwd": 48, "fused_ffn_bwd": 48,
                 "fused_conv_dp_stats": 21, "fused_conv_dp_fwd": 21,
                 "fused_conv_dp_bwd1": 21, "fused_conv_dp_bwd2": 21}


def _dp_rank_setup():
    """(rank, world) of a spawned rank, with the fp32 products of the checks
    in full fp32."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dist.get_rank(), dist.get_world_size()


def k3dp_rank(device, lib_shapes):
    """Phase 15 on one of the gloo ranks sharing the card: each rank takes its
    half of phase 12's (16, T, d) inputs and runs K3dp (the four passes with
    the statistics all-reduced between them) against the plain DP stages on
    the card, with the masks of its own seed identical at dropout 0.1; keeps
    the dropout-0 results for the parent's single-process comparison. Then
    the library yardstick at the step's B=8 shapes: the port's unfused
    module with its BatchNorm synced over the ranks, and the all-reduce of
    one (2E,) vector over gloo; both ranks run them in step, rank 0's times
    are kept."""
    import torch.distributed as dist

    from avec_tpu_torch.models.conformer import ConvolutionModule
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.ops.ffn import dropout_mask, shard_seed
    from avec_tpu_torch.ops.layers import init_params

    rank, world = _dp_rank_setup()
    say = log if rank == 0 else (lambda *args: None)
    dev = torch.device("cuda")
    names = ("x",) + cm.PARAM_NAMES
    stats, fwd, bwd1, bwd2 = cm.KERNELS_DP
    owner = {"mean": stats, "var": stats, "y": fwd, "pw2_w": bwd1,
             "pw2_b": bwd1, "bn_w": bwd1, "bn_b": bwd1}
    errs, abs_errs, kept = {}, {n: 0.0 for n in cm.KERNELS_DP}, {}
    for b, t, d, k in CONV_SHAPES:
        for dtype, tol, wtol in ((torch.float32, 1e-4, 5e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = conv_inputs(b, t, d, k, dtype, seed=d)
            half = b // world
            x, g = (a[rank * half:(rank + 1) * half].contiguous()
                    for a in (x, g))
            for padding, drop in (("same", 0.0), ("same", 0.1),
                                  ("causal", 0.0), ("causal", 0.1)):
                outs, grads = conv_run(x, g, params, padding, drop, True,
                                       dp=True)
                torch.cuda.synchronize()
                want_outs, want = conv_run(x, g, params, padding, drop, False,
                                           dp=True)
                key = f"T{t}_d{d}_{str(dtype)[6:]}_{padding}_drop{drop}"
                e = {nm: rel_err(a, w) for nm, a, w in zip(
                    ("y", "mean", "var"), outs, want_outs)}
                e.update({nm: rel_err(a, w) for nm, a, w in zip(names, grads,
                                                                want)
                          if nm != "dw_b"})
                errs[key] = e
                if dtype == torch.float32:
                    pairs = list(zip(("y", "mean", "var"), outs, want_outs))
                    for nm, a, w in pairs + list(zip(names, grads, want)):
                        kern = owner.get(nm, bwd2)
                        abs_errs[kern] = max(abs_errs[kern], max_abs(a, w))
                if drop:
                    dropped = dropout_mask(
                        shard_seed(4321, rank), half * t, d, 1, 1.0 - drop,
                        dev, tile_rows=t).reshape(half, t, d) == 0
                    for y in (outs[0], want_outs[0]):
                        kept_zero = float((y[~dropped] == 0).float().mean())
                        if not (bool((y[dropped] == 0).all())
                                and kept_zero < 5e-3):
                            raise AssertionError(
                                f"rank {rank} dropout masks differ: {key}")
                worst_w = max(v for nm, v in e.items()
                              if nm in cm.PARAM_NAMES)
                x_tol = wtol if dtype == torch.float32 else tol
                say(f"K3dp rank {rank} vs plain DP stages {key}: y "
                    f"{e['y']:.2e} mean {e['mean']:.2e} var {e['var']:.2e} "
                    f"(tol {tol}) dx {e['x']:.2e} (tol {x_tol}) params "
                    f"{worst_w:.2e} (tol {wtol})")
                if not (max(e["y"], e["mean"], e["var"]) <= tol
                        and e["x"] <= x_tol and worst_w <= wtol
                        and not grads[names.index("dw_b")].abs().any()):
                    raise AssertionError(f"rank {rank}: K3dp disagrees with "
                                         f"the plain DP stages: {key} {e}")
                if drop == 0.0:
                    kept[(b, t, d, k, str(dtype)[6:], padding)] = (
                        [a.float().cpu() for a in outs],
                        [a.float().cpu() for a in grads])
            del x, g, params
    lib = {}
    for t, d, e, k, count in lib_shapes:
        x, g, _ = conv_inputs(8, t, d, k, torch.bfloat16, seed=t + 2)
        unfused = init_params(ConvolutionModule(d, e, 1, k, "same", 0.1,
                                                fused_conv=False),
                              torch.Generator().manual_seed(3)).to(dev).train()
        unfused.layers["4"].process_group = dist.group.WORLD

        def run(backward: bool):
            if backward:
                unfused(x.detach().requires_grad_(True)).backward(g)
            else:
                with torch.no_grad():
                    unfused(x)

        v = torch.zeros(2 * e, device=dev)
        t_f = cuda_time_ms(lambda: run(False))
        t_b = cuda_time_ms(lambda: run(True)) - t_f
        t_ar = cuda_time_ms(lambda: dist.all_reduce(v))
        lib[(t, d)] = {"count": count, "fwd_ms": t_f, "bwd_ms": t_b,
                       "all_reduce_ms": t_ar}
        del x, g, unfused
    return {"rank": rank, "errs": errs, "abs_errs": abs_errs, "kept": kept,
            "lib": lib}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in tensors:
        h.update(a.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_rank(device):
    """Phase 16 on one of the gloo ranks sharing the card: the
    data-parallel trainer at full width on its 8 of the 16 utterances, 1
    warm-up + 3 counted steps, a digest of the parameters, the step time and
    the peak memory of this rank; then one fp32 step with dropout and
    SpecAugment off (rank 0 keeps the global gradients and BN statistics)."""
    import torch.distributed as dist

    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    rank, world = _dp_rank_setup()
    batch = make_train_batch(np.random.RandomState(0))
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, loss=CTCLoss(zero_infinity=True),
                      data_parallel=True, **DP_ROUTE)
    per_step = trainer.model.kernel_launches_per_step()
    if per_step != DP_WANT_STEPS:
        raise AssertionError(f"launches per step {per_step} != "
                             f"{DP_WANT_STEPS}")
    history, launches = counted_train_steps(trainer, batch, per_step,
                                            verbose=rank == 0)
    digest = _digest(trainer.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the step's one flat all-reduce of the gradients and losses, alone
    flat = torch.zeros(sum(p.numel() for p in trainer.model.parameters())
                       + 7, device=device)
    grad_ar_ms = cuda_time_ms(lambda: dist.all_reduce(flat), iters=3,
                              warmup=1)
    del trainer, flat
    torch.cuda.empty_cache()
    trainer = Trainer(device="cuda", precision="float32", seed=0,
                      vocab_size=256, loss=CTCLoss(zero_infinity=True),
                      data_parallel=True, **DP_ROUTE)
    trainer.model.set_regularization(False)
    losses, grads = trainer.loss_and_grads(batch)
    fp32 = {"loss": float(losses["loss"]), "grads_digest": _digest(
        grads.values())}
    if rank == 0:
        fp32["grads"] = {n: a.cpu() for n, a in grads.items()}
        fp32["stats"] = {n: b.detach().cpu() for n, b in
                         trainer.model.named_buffers() if "running_" in n}
    return {"rank": rank, "world": world, "history": history,
            "launches": launches, "params_digest": digest, "step_ms": ms,
            "grad_all_reduce_ms": grad_ar_ms, "peak_gib": peak, "fp32": fp32}


def _step_diffs(a, b):
    """Differences of two fp32 steps, each (losses, gradients by name): the
    largest relative loss difference, the worst leaf (max abs difference
    over the leaf's largest entry; leaves below 1e-6 of the largest gradient
    entry left out), the largest difference over the largest gradient entry,
    and the gradient norm's relative difference."""
    (la, ga), (lb, gb) = a, b
    gmax = max(float(g.abs().max()) for g in gb.values())
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum()
                                           for g in gs.values())))
    worst = max((max_abs(ga[n], g) / float(g.abs().max()), n)
                for n, g in gb.items() if float(g.abs().max()) > 1e-6 * gmax)
    return {"loss_rel": max(abs(la[k] - v) / abs(v) for k, v in lb.items()),
            "worst_leaf_rel": worst[0], "worst_leaf": worst[1],
            "grads_rel_to_largest": max(max_abs(ga[n], g)
                                        for n, g in gb.items()) / gmax,
            "grad_norm_rel": abs(norm(ga) - norm(gb)) / norm(gb),
            "keys_equal": set(la) == set(lb) and set(ga) == set(gb)}


def nccl_world1_rank(device):
    """Phase 17 on one NCCL rank: fp32, dropout and SpecAugment off, the
    same 16 utterances; the data-parallel trainer against the plain trainer
    and the plain trainer against itself (the run-to-run floor), first
    through the kernels' plain versions with cuDNN deterministic, then
    through the kernels (whose atomic sums vary from run to run)."""
    import torch.distributed as dist

    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    _dp_rank_setup()
    batch = make_train_batch(np.random.RandomState(0))
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for route, kernels in (("plain_versions", False), ("kernels", True)):
        torch.backends.cudnn.deterministic = not kernels
        runs = []
        for dp in (True, False, False):
            trainer = Trainer(device="cuda", precision="float32", seed=0,
                              vocab_size=256, loss=CTCLoss(zero_infinity=True),
                              data_parallel=dp, **DP_ROUTE)
            trainer.model.set_regularization(False)
            trainer.model.set_kernels(kernels)
            losses, grads = trainer.loss_and_grads(batch)
            runs.append(({k: float(v) for k, v in losses.items()}, grads))
            del trainer
            torch.cuda.empty_cache()
        out[route] = {"dp_vs_plain": _step_diffs(runs[0], runs[1]),
                      "plain_vs_plain": _step_diffs(runs[2], runs[1])}
        del runs
    torch.backends.cudnn.deterministic = False
    return out


def dp_phases(detail, conv_shapes):
    """Phases 15-17: K3dp on two gloo ranks against the single-process
    K3/K3b call and the plain DP stages, the data-parallel train path at full
    width on two gloo ranks, and the NCCL path at world size 1. Returns the
    four K3dp entries of the kernels line."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.parallel.dist import spawn
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    _cuda.build()                  # the ranks load what the parent built
    names = ("x",) + cm.PARAM_NAMES
    lib_shapes = sorted((t, d, e, k, count)
                        for (_, t, d, e, k), count in conv_shapes.items())

    # ---- 15. K3dp on two ranks
    ranks = spawn(k3dp_rank, DP_RANKS, "gloo", "cuda:0", lib_shapes,
                  timeout=600)
    dp_errs = {}
    for key in ranks[0]["kept"]:
        b, t, d, k, dname, padding = key
        dtype = getattr(torch, dname)
        tol, wtol = (1e-4, 5e-4) if dname == "float32" else (2e-2, 3e-2)
        x, g, params = conv_inputs(b, t, d, k, dtype, seed=d)
        want_outs, want = conv_run(x, g, params, padding, 0.0, True)
        kept = [r["kept"][key] for r in ranks]
        outs = [torch.cat([o[0][0] for o in kept])] + kept[0][0][1:]
        grads = [torch.cat([o[1][0] for o in kept])]
        grads += [sum(o[1][i] for o in kept) for i in range(1, len(names))]
        e = {nm: rel_err(a, w.cpu()) for nm, a, w in zip(
            ("y", "mean", "var"), outs, want_outs)}
        e.update({nm: rel_err(a, w.cpu()) for nm, a, w in zip(names, grads,
                                                              want)
                  if nm != "dw_b"})
        label = f"T{t}_d{d}_{dname}_{padding}"
        dp_errs[label] = e
        x_tol = wtol if dname == "float32" else tol
        worst_w = max(v for nm, v in e.items() if nm in cm.PARAM_NAMES)
        log(f"K3dp on {DP_RANKS} ranks vs one K3/K3b call {label}: y "
            f"{e['y']:.2e} mean {e['mean']:.2e} var {e['var']:.2e} (tol "
            f"{tol}) dx {e['x']:.2e} (tol {x_tol}) params {worst_w:.2e} "
            f"(tol {wtol})")
        if not (max(e["y"], e["mean"], e["var"]) <= tol and e["x"] <= x_tol
                and worst_w <= wtol):
            raise AssertionError(f"K3dp disagrees with one K3/K3b call: "
                                 f"{label} {e}")
        del x, g, params, want_outs, want
    abs_errs = {n: max(r["abs_errs"][n] for r in ranks)
                for n in cm.KERNELS_DP}
    detail["k3dp_vs_one_call"] = dp_errs
    detail["k3dp_vs_plain_dp"] = {r["rank"]: r["errs"] for r in ranks}
    lib = ranks[0]["lib"]
    del ranks
    torch.cuda.empty_cache()

    # ---- 16. the data-parallel train path at full width, two ranks
    batch = make_train_batch(np.random.RandomState(0))
    ref = Trainer(device="cuda", precision="float32", seed=0, vocab_size=256,
                  loss=CTCLoss(zero_infinity=True), **DP_ROUTE)
    ref.model.set_regularization(False)
    losses, grads = ref.loss_and_grads(batch)
    want = (float(losses["loss"]), {n: a.cpu() for n, a in grads.items()},
            {n: b.detach().cpu() for n, b in ref.model.named_buffers()
             if "running_" in n})
    # the fp32 noise floor of this gradient: the same step, the same
    # parameters, the 16 utterances in another order (equal in exact
    # arithmetic; sums are taken in another order, as across ranks)
    _, grads = ref.loss_and_grads(reorder(batch))
    floor = max((max_abs(a.cpu(), want[1][n])
                 / max(float(want[1][n].abs().max()), 1e-30), n)
                for n, a in grads.items() if FRONT_END in n)
    floor_rest = max((max_abs(a.cpu(), want[1][n])
                      / max(float(want[1][n].abs().max()), 1e-30), n)
                     for n, a in grads.items() if FRONT_END not in n
                     and float(want[1][n].abs().max()) > 1e-6 * max(
                         float(w.abs().max()) for w in want[1].values()))
    log(f"fp32 one process, the same utterances reordered: worst video "
        f"front-end leaf {floor[1]} {floor[0]:.2e}, worst other leaf "
        f"{floor_rest[1]} {floor_rest[0]:.2e} (the trunk's fp32 noise floor)")
    detail["fp32_reorder_floor"] = {"front_end": floor, "other": floor_rest}
    del ref, losses, grads
    torch.cuda.empty_cache()
    ranks = spawn(dp_train_rank, DP_RANKS, "gloo", "cuda:0", timeout=900)
    digests = {r["params_digest"] for r in ranks}
    log(f"data-parallel train path, {DP_RANKS} gloo ranks on one card: "
        f"launches per rank over {TRAIN_STEPS} steps "
        + json.dumps([r["launches"] for r in ranks])
        + f"; parameters after the steps bit-identical across ranks: "
        f"{len(digests) == 1}")
    if len(digests) != 1:
        raise AssertionError("ranks hold different parameters")
    if len({r["fp32"]["grads_digest"] for r in ranks}) != 1 or len(
            {r["fp32"]["loss"] for r in ranks}) != 1:
        raise AssertionError("ranks hold different global gradients")
    fp32 = ranks[0]["fp32"]
    agree = check_agreement(
        f"fp32 data-parallel step ({DP_RANKS} ranks) vs one process",
        (fp32["loss"], fp32["grads"], fp32["stats"]), want, loss_tol=1e-5,
        front_end_tol=0.15)
    step_ms = max(r["step_ms"] for r in ranks)
    train = {"ranks": DP_RANKS, "backend": "gloo", "shared_card": True,
             "global_batch": 16, "steps": ranks[0]["history"],
             "launches_per_rank": [r["launches"] for r in ranks],
             "step_ms_per_rank": [r["step_ms"] for r in ranks],
             "grad_all_reduce_ms_per_rank": [r["grad_all_reduce_ms"]
                                             for r in ranks],
             "global_utterances_per_s": 16 / step_ms * 1e3,
             "peak_gib_per_rank": [r["peak_gib"] for r in ranks], **agree}
    log("train, data-parallel (two ranks time-sliced on one card over gloo; "
        "not a data-parallel speed) " + json.dumps(
            {k: v for k, v in train.items() if k != "steps"}))
    detail["training_dp"] = train
    launches = ranks[0]["launches"]
    del ranks, fp32, want
    torch.cuda.empty_cache()

    # ---- 17. NCCL at world size 1
    nccl, = spawn(nccl_world1_rank, 1, "nccl", "cuda:0", timeout=600)
    for route in ("plain_versions", "kernels"):
        log(f"NCCL world size 1, {route}, fp32, dropout off: data-parallel "
            f"vs plain trainer " + json.dumps(nccl[route]["dp_vs_plain"])
            + "; plain vs plain (run-to-run floor) "
            + json.dumps(nccl[route]["plain_vs_plain"]))
    det, ker = nccl["plain_versions"]["dp_vs_plain"], nccl["kernels"]
    if not (nccl["backend"] == "nccl" and det["keys_equal"]
            and det["loss_rel"] <= 1e-6 and det["worst_leaf_rel"] <= 1e-6
            and ker["dp_vs_plain"]["keys_equal"]
            and ker["dp_vs_plain"]["loss_rel"] <= 1e-6):
        raise AssertionError(f"NCCL data-parallel step disagrees: {nccl}")
    detail["nccl_world1"] = nccl

    # ---- K3dp times per rank at the B=8 shapes (this process, alone on
    # the card), bounds, plain stages, the library yardstick of phase 15
    acc = {n: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bytes": 0, "ops": 0.0}
           for n in cm.KERNELS_DP}
    for t, d, e, k, count in lib_shapes:
        x, g, params = conv_inputs(8, t, d, k, torch.bfloat16, seed=t + 2)
        pad_lo = cm.pad_lo_for("same", k)
        times = time_conv_passes(x, g, params, 0.1, 77)
        s1, s2 = cm.conv_stats_reference(x, params, pad_lo)
        mean, _, rstd = cm.batch_stats(s1, s2, 8 * t, 1e-5)
        _, _, r1, r2 = cm.conv_bwd1_reference(x, g, params, mean, rstd, 77,
                                              pad_lo, drop_rate=0.1)
        rn1, rn2 = r1 / (8 * t), r2 / (8 * t)
        plain = (lambda: cm.conv_stats_reference(x, params, pad_lo),
                 lambda: cm.conv_fwd_reference(x, params, mean, rstd, 77,
                                               pad_lo, drop_rate=0.1),
                 lambda: cm.conv_bwd1_reference(x, g, params, mean, rstd, 77,
                                                pad_lo, drop_rate=0.1),
                 lambda: cm.conv_bwd2_reference(x, g, params, mean, rstd,
                                                rn1, rn2, 77, pad_lo,
                                                drop_rate=0.1))
        cost = conv_cost(8, t, d, e, e, k, 2)
        row = lib[(t, d)]
        lib_ms = {cm.KERNELS_DP[1]: row["fwd_ms"],
                  cm.KERNELS_DP[3]: row["bwd_ms"]}
        for name, dp_name, fn in zip(cm.KERNELS, cm.KERNELS_DP, plain):
            nb, no = cost[name]
            acc[dp_name]["ms"] += count * times[name]
            acc[dp_name]["device_ms"] += count * times[name + "_device"]
            acc[dp_name]["plain_ms"] += count * cuda_time_ms(fn, iters=5)
            acc[dp_name]["library_ms"] += count * lib_ms.get(dp_name, 0.0)
            acc[dp_name]["bytes"] += count * nb
            acc[dp_name]["ops"] += count * no
        row.update({n: times[n] for n in cm.KERNELS})
        row.update({n + "_device": times[n + "_device"] for n in cm.KERNELS})
        log(f"K3dp per rank at B=8 T={t} d={d} x{count}: "
            + "; ".join(f"{n[11:]} {times[n]:.4f} ms (device "
                        f"{times[n + '_device']:.4f}, bound "
                        f"{bound(*cost[n], 'bf16')[0]:.5f})"
                        for n in cm.KERNELS)
            + f"; unfused module under sync-BN (two ranks time-sliced) fwd "
            f"{row['fwd_ms']:.4f} ms, bwd {row['bwd_ms']:.4f} ms; all-reduce "
            f"of the (2E,) statistics over gloo {row['all_reduce_ms']:.4f} ms")
        del x, g, params
    detail["k3dp_b8"] = {f"T{t}_d{d}": row for (t, d), row in lib.items()}
    replaces = dict(zip(cm.KERNELS_DP, (
        "avec_tpu/ops/pallas_conv_module.py:582",
        "avec_tpu/ops/pallas_conv_module.py:612",
        "avec_tpu/ops/pallas_conv_module.py:648",
        "avec_tpu/ops/pallas_conv_module.py:679")))
    entries = []
    for name in cm.KERNELS_DP:
        b_ms, b_by = bound(acc[name]["bytes"], acc[name]["ops"], "bf16")
        log(f"{name} per rank per step (B=8): {acc[name]['ms']:.4f} ms "
            f"(device {acc[name]['device_ms']:.4f}), bound {b_ms:.5f} "
            f"({b_by}), plain {acc[name]['plain_ms']:.4f}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "avec_tpu_torch/csrc/conv_module.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": abs_errs[name], "ms": acc[name]["ms"],
            "device_ms": acc[name]["device_ms"],
            "plain_ms": acc[name]["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": (acc[name]["library_ms"] if name in (
                cm.KERNELS_DP[1], cm.KERNELS_DP[3]) else None)})
    return entries


def time_ffn_bwd_kernel(x, g, params, drop, seed, check: bool = False):
    """Time and device time of the fused-FFN backward kernel alone, through the library's C
    entry point with the wrapper's own arguments and preallocated gradient
    buffers (the wrapper's autograd bookkeeping and its six zero-fills are
    host work that a slow host would add to the time; this call is outside
    any count). With `check` it launches once into zeroed buffers and returns
    (dx, six parameter gradients) instead."""
    from avec_tpu_torch.ops import _cuda, ffn

    n, d = x.shape
    f = params[2].shape[0]
    thr, inv_keep = ffn._threshold(1.0 - drop)
    dx = torch.empty_like(x)
    grads = [torch.zeros_like(p) for p in params]
    scratch = ffn.bwd_scratch(x, f)
    args = (x.data_ptr(), g.data_ptr(), *(p.data_ptr() for p in params[:5]),
            dx.data_ptr(), *(t.data_ptr() for t in grads), scratch.data_ptr(),
            n, d, f, 1e-6, 1, seed, thr, inv_keep,
            int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))
    bwd = ffn._lib()[1]

    def launch():
        _cuda.check(bwd(*args), "fused_ffn_bwd")

    if check:
        launch()
        torch.cuda.synchronize()
        return [dx] + grads
    return cuda_time_ms(launch), device_time_ms(launch)[0]


def time_single_bwd_kernel(q, k, v, dout, lse, delta, lengths, scale):
    """Time and device time of the dq kernel alone, through the library's C entry point with
    the wrapper's own arguments (the wrapper launches dq and dk/dv together
    and counts both; this call is outside any count)."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.flash_attention import _lib_bwd

    b, h, t, da = q.shape
    dq = torch.empty_like(q)
    fn_dq, _ = _lib_bwd()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            dq.data_ptr(), b * h, h, t, da, v.shape[-1], float(scale),
            int(q.dtype == torch.bfloat16), _cuda.stream_ptr(q))

    def launch():
        _cuda.check(fn_dq(*args), "flash_attention_bwd_dq")

    return cuda_time_ms(launch), device_time_ms(launch)[0]


def _category(name: str) -> str:
    low = name.lower()
    conv = ("conv_ln_stats_kernel", "conv_pw1_kernel",
            "conv_depthwise_kernel", "conv_pw2_kernel", "conv_grad_w2_kernel",
            "conv_grad_bn_kernel", "conv_depthwise_bwd_kernel",
            "conv_grad_w1_kernel", "conv_grad_h_kernel", "conv_ln_bwd_kernel",
            "conv_cast_kernel", "conv_prep_kernel", "conv_pw1_wgmma_kernel",
            "conv_grad_bn_wgmma_kernel", "conv_depthwise_bwd_bf16_kernel",
            "conv_ln_bwd_rows_kernel", "conv_bwd2_reduce_kernel",
            # hopper.cuh's product launch: K3b-2 runs two jobs, K1b three
            "wgmma_products_kernel<2>")
    # checked first: K2's "ln_stats_kernel" and "ln_bwd_kernel" end two of
    # these names
    if any(k in low for k in conv):
        return "fused convolution module kernels (K3 + K3b)"
    att = ("ln_stats_kernel", "qkv_kernel", "relpos_u_kernel", "scores_kernel",
           "att_v_kernel", "out_proj_kernel", "grad_out_kernel",
           "grad_wo_kernel", "datt_ds_kernel", "grad_kv_kernel",
           "grad_relpos_u_kernel", "grad_q_kernel", "grad_pos_kernel",
           "grad_w_qkv_kernel", "grad_h_kernel", "ln_bwd_kernel",
           "col_sums_kernel", "cast16_kernel", "ln_h16_kernel",
           "qkv16_kernel", "relpos16_kernel", "att16_kernel",
           "out_proj16_kernel", "kv16_kernel", "weights16_kernel",
           "ln_bwd16_kernel", "reduce16_kernel")
    for cat, keys in (("fused attention module kernels (K2 + K2b)", att),
                      ("flash kernel (K4)", ("flash_fwd_kernel",)),
                      ("flash backward kernels (K4b)", ("flash_bwd_",)),
                      ("fused FFN forward kernel (K1)", ("ffn_fwd_",)),
                      ("fused FFN backward kernel (K1b)",
                       ("ffn_bwd_", "wgmma_products_kernel<3>")),
                      ("stem kernel (K5)", ("bn_relu_pool_kernel",)),
                      ("CTC loss", ("ctc_loss",)),
                      ("optimizer (Adam, foreach)", ("multi_tensor",)),
                      ("host-to-device copy", ("memcpy htod",)),
                      ("device copy / cast", ("copy",)),
                      ("convolution", ("conv", "fprop", "implicit")),
                      ("matmul", ("gemm", "cublas", "cutlass", "xmma"))):
        if any(k in low for k in keys):
            return cat
    return "elementwise / reduction / other"


def profile_forward(srv, inputs):
    """Device time of one served bf16 forward, beside its CUDA-event time."""
    srv.model.set_kernels(True)
    return profile_call("forward", lambda: srv.forward(inputs))


def profile_train_step(trainer, batch):
    """Device time of one bf16 train step, beside its CUDA-event time."""
    trainer.model.set_kernels(True)
    return profile_call("train step", lambda: trainer.train_step(batch))


def profile_call(what: str, fn):
    """Device time of one call of `fn` (`traced_device_rows`), by category
    and by kernel name, beside the call's CUDA-event time."""
    fwd_ms = cuda_time_ms(fn, iters=3, warmup=1)
    rows, cats = traced_device_rows(fn), {}
    for us, _, key in rows:
        cat = _category(key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"profile: {what} {fwd_ms:.3f} ms (CUDA events), device busy "
        f"{busy:.3f} ms in the traced {what}, idle share "
        f"{max(0.0, 1 - busy / fwd_ms):.3f}")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.4f} ms  {cat}")
    for us, count, key in rows[:12]:
        log(f"  {us / 1e3:9.4f} ms {count:5d}x {key[:100]}")
    return {"what": what, "ms": fwd_ms, "busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / fwd_ms), "categories_ms": cats,
            "top": [{"ms": us / 1e3, "count": c, "name": k}
                    for us, c, k in rows[:40]]}


if __name__ == "__main__":
    sys.exit(main())
