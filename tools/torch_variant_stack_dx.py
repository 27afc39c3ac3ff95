#!/usr/bin/env python3
"""How far the fp32 input gradient of `chip_smoke.py` phase 31 (b)'s
variant stack moves between the fused kernels and their plain versions,
and between two runs of the same path.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_variant_stack_dx.py [--deterministic]

The stack (`chip_smoke._variant_stack`: a transposed stride-2 block, a
`batch_norm=False` block and a ReLU block at width 360, 4 heads) in
training mode with dropout off, fp32 (TF32 off), B=16, T=38 -> 76, phase 31
(b)'s seeds. For its first block, its first two and all three it prints one
JSON line: the largest difference over the largest entry of the input
gradient between two runs through the kernels (`kernel_rerun_dx`), two
runs through the plain versions (`plain_rerun_dx`), and the kernels against
the plain versions (`kernel_vs_plain_y`, `kernel_vs_plain_dx`).
`--deterministic` sets `torch.backends.cudnn.deterministic`. Needs CUDA;
imports nothing of JAX.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.layers import init_params

    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.deterministic
    dev = torch.device("cuda")
    blocks = init_params(cs._variant_stack(),
                         torch.Generator().manual_seed(31)).to(dev).train()
    for m in blocks.modules():
        if hasattr(m, "regularize"):
            m.regularize = False
    gen = torch.Generator().manual_seed(32)
    lengths = torch.tensor([38] + [int(v) for v in torch.randint(
        10, 38, (15,), generator=gen)], dtype=torch.int32, device=dev)
    x = torch.randn(16, 38, 360, generator=gen).to(dev)
    g = torch.randn(16, 76, 360, generator=gen).to(dev)

    def run(kernels: bool, depth: int):
        for m in blocks.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = kernels
        x32 = x.clone().requires_grad_(True)
        y = cs._run_variant_stack(blocks[:depth], x32, lengths)
        (y * g[:, :y.shape[1]]).sum().backward()
        blocks.zero_grad(set_to_none=True)
        return y.detach(), x32.grad

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for depth in (1, 2, 3):
        k1, k2 = run(True, depth), run(True, depth)
        p1, p2 = run(False, depth), run(False, depth)
        print(json.dumps({
            "blocks": depth, "card": cs.gpu_line(),
            "deterministic_cudnn": args.deterministic,
            "kernel_rerun_dx": rel(k1[1], k2[1]),
            "plain_rerun_dx": rel(p1[1], p2[1]),
            "kernel_vs_plain_y": rel(k1[0], p1[0]),
            "kernel_vs_plain_dx": rel(k1[1], p1[1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
