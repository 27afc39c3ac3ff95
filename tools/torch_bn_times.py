#!/usr/bin/env python3
"""Times of the training BatchNorm kernels (`ops/batch_norm.py`) of the
PyTorch/H100 port at the video front end's shapes, beside their byte bounds,
the plain PyTorch versions and cuDNN's `F.batch_norm`.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_bn_times.py [--frames N]

For the ResNet trunk's stage 1 (N frames of 64 x 22 x 22) and stage 4 (512
x 3 x 3) and the stem's conv output (N frames of 64 x 44 x 44), all bf16 and
channels-last (N = 6432 by default: 32 utterances of about 201 frames, one
micro-batch of the `av_train` cell), it times each kernel call through its
wrapper (direct calls between CUDA events, host cost included) and its
device time (torch.profiler), beside its byte bound (each input byte read
once and each output byte written once, over 3.35 TB/s). Then one
BatchNorm + ReLU forward and backward three ways: through the kernels
(`batch_norm_train`), through the plain path of `ops/layers.py:BatchNorm`
(its fp32 ops under autograd, as before the kernels) and through cuDNN
(`F.batch_norm` in training mode, then `torch.relu`). It prints one line a
measurement and one JSON line with everything, the card's name and its power
limit. Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import torch
import torch.nn.functional as F

HBM = 3.35e12       # bytes/s, the H100 SXM's published peak


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds to issue one `fn()`, over `calls` calls in a row
    without a device sync (the kernels are short enough that the launch
    queue never fills)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def host_costs(bn, BatchNorm, _cuda, dev) -> dict:
    """Host cost of each entry point and of one BatchNorm + ReLU forward and
    backward through the kernels, the plain path and cuDNN, at a small
    shape where the host sets the pace."""
    shape = (64, 512, 3, 3)
    x = torch.randn(shape, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    g = torch.randn_like(x)
    w = torch.ones(shape[1], device=dev)
    b = torch.zeros(shape[1], device=dev)
    st = bn.stats(x, 1e-5)
    y = bn.apply(x, st, w, b, None, True)
    red = bn.bwd_reduce(g, x, y, st, w)
    module = BatchNorm(shape[1]).to(dev).train()

    def step(relu=True):
        xa = x.detach().requires_grad_(True)
        module(xa, relu=relu).backward(g)

    def plain():
        module.use_kernel = False
        try:
            step()
        finally:
            module.use_kernel = True

    def cudnn():
        xa = x.detach().requires_grad_(True)
        torch.relu(F.batch_norm(xa, None, None, module.weight, module.bias,
                                True, 0.1, 1e-5)).backward(g)

    return {"stats": host_us(lambda: bn.stats(x, 1e-5)),
            "apply": host_us(lambda: bn.apply(x, st, w, b, None, True)),
            "bwd_reduce": host_us(lambda: bn.bwd_reduce(g, x, y, st, w)),
            "bwd_dx": host_us(lambda: bn.bwd_dx(g, x, y, st, red)),
            "stream_ptr": host_us(lambda: _cuda.stream_ptr(x)),
            "current_stream": host_us(lambda: torch.cuda.current_stream(
                x.device).cuda_stream),
            "empty": host_us(lambda: torch.empty(1024, device=dev)),
            "fwd_bwd_kernels": host_us(step, 50),
            "fwd_bwd_plain": host_us(plain, 50),
            "fwd_bwd_cudnn": host_us(cudnn, 50)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6432)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from avec_tpu_torch.ops import _cuda, batch_norm as bn
    from avec_tpu_torch.ops.layers import BatchNorm

    _cuda.build()
    dev = torch.device("cuda")
    n = args.frames
    shapes = {"stage1": (n, 64, 22, 22), "stage4": (n, 512, 3, 3),
              "stem": (n, 64, 44, 44)}
    out = {"gpu": cs.gpu_line(), "frames": n, "shapes": {}}
    print(out["gpu"], flush=True)
    for name, shape in shapes.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        cl = torch.channels_last

        def act():
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16).contiguous(memory_format=cl)

        x, g, res = act(), act(), act()
        c = shape[1]
        w = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        st = bn.stats(x, 1e-5)
        y = bn.apply(x, st, w, b, None, True)
        red = bn.bwd_reduce(g, x, y, st, w)
        e = x.numel() * x.element_size()    # bytes of one activation
        calls = {
            "stats": (lambda: bn.stats(x, 1e-5), e),
            "apply_relu": (lambda: bn.apply(x, st, w, b, None, True), 2 * e),
            "apply_res_relu": (lambda: bn.apply(x, st, w, b, res, True),
                               3 * e),
            "bwd_reduce_gated": (lambda: bn.bwd_reduce(g, x, y, st, w), 3 * e),
            "bwd_reduce": (lambda: bn.bwd_reduce(g, x, None, st, w), 2 * e),
            "bwd_dx_gated": (lambda: bn.bwd_dx(g, x, y, st, red), 4 * e),
            "bwd_dx_gated_g": (lambda: bn.bwd_dx(g, x, y, st, red, True),
                               5 * e),
            "bwd_dx": (lambda: bn.bwd_dx(g, x, None, st, red), 3 * e),
        }
        rec = {}
        for call, (fn, nbytes) in calls.items():
            direct = cs.cuda_time_ms(fn, iters=20)
            device, kernels = cs.device_time_ms(fn, iters=10)
            bound = nbytes / HBM * 1e3
            rec[call] = {"ms": direct, "device_ms": device, "bound_ms": bound,
                         "bytes": nbytes, "kernels": kernels}
            print(f"{name} {call}: {direct:.4f} ms direct, device "
                  f"{device:.4f} ms ({device / bound:.2f}x the bound "
                  f"{bound:.4f} ms)", flush=True)

        # one BatchNorm + ReLU forward and backward, three ways
        module = BatchNorm(c).to(dev).train()
        with torch.no_grad():
            module.weight.copy_(w)
            module.bias.copy_(b)

        def kernels_step():
            xa = x.detach().requires_grad_(True)
            yk = module(xa, relu=True)
            yk.backward(g)

        def plain_step():
            module.use_kernel = False
            try:
                kernels_step()
            finally:
                module.use_kernel = True

        def cudnn_step():
            xa = x.detach().requires_grad_(True)
            wa, ba = module.weight, module.bias
            yc = torch.relu(F.batch_norm(xa, None, None, wa, ba, True, 0.1,
                                         1e-5))
            yc.backward(g)

        whole = {}
        bound = (1 + 2 + 3 + 4) * e / HBM * 1e3
        for way, fn in (("kernels", kernels_step), ("plain", plain_step),
                        ("cudnn", cudnn_step)):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            direct = cs.cuda_time_ms(fn, iters=5, warmup=2)
            peak = torch.cuda.max_memory_allocated() - base
            device, kernels = cs.device_time_ms(fn, iters=5)
            whole[way] = {"ms": direct, "device_ms": device,
                          "kernel_names": len(kernels),
                          "peak_extra_gib": peak / 2 ** 30,
                          "kernels": kernels}
            print(f"{name} BN+ReLU fwd+bwd {way}: {direct:.4f} ms direct, "
                  f"device {device:.4f} ms ({device / bound:.2f}x the "
                  f"kernels' bound {bound:.4f} ms), {len(kernels)} kernels, "
                  f"peak above the inputs {peak / 2 ** 30:.3f} GiB",
                  flush=True)
        out["shapes"][name] = {"shape": list(shape), "calls": rec,
                               "bn_relu_fwd_bwd": whole,
                               "bn_relu_fwd_bwd_bound_ms": bound}
        del x, g, res, y, red
        torch.cuda.empty_cache()
    out["host_us"] = host_costs(bn, BatchNorm, _cuda, dev)
    print("host us a call (stage 4, 64 frames):", json.dumps(out["host_us"]),
          flush=True)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "bn_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "shapes"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
