"""The yardstick's arithmetic: the card's peaks, the bytes and operations a
hand-written kernel call needs (copied from the port's proof script, with
the stem kernel's added), and the model's forward FLOPs on padded shapes.

A kernel's bound is the larger of its bytes over the HBM bandwidth and its
operations over the bf16 tensor-core peak. Model FLOPs count the products
of the plain reference (`reference/model.py`): linear layers, convolutions,
attention scores and values, the relative-position table's projection and
the mel filterbank; a training step counts 3 forwards, no recompute.
"""

from typing import Dict, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    """Least seconds a call can take on the card."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])


# --------------------------------------------------------------- kernels
def ffn_cost(n, d, f, es):
    """(forward bytes, forward ops, backward bytes, backward ops): x read and
    y written once, fp32 parameters read once (and their gradients written
    once in the backward, beside x, g and dx); two products forward
    (4 N d F), five in the backward (10 N d F)."""
    pbytes = 4 * (2 * d * f + f + 3 * d)
    return (2 * n * d * es + pbytes, 4.0 * n * d * f,
            3 * n * d * es + 2 * pbytes, 10.0 * n * d * f)


def att_cost(b, t, d, heads, es):
    """(forward bytes, forward ops, backward bytes, backward ops) of the
    fused attention module with n = b t rows; every sequence at full T."""
    n, pbytes = b * t, 4 * (2 * d + 5 * (d * d + d))
    table = t * d * es + 4 * b
    sq = float(b) * t * t * d
    f_ops = 10.0 * n * d * d + sq * (4 + 2 * heads)
    b_ops = 28.0 * n * d * d + sq * (12 + 4 * heads)
    return (2 * n * d * es + pbytes + table, f_ops,
            3 * n * d * es + 2 * pbytes + table, b_ops)


def conv_cost(b, t, d, e, eo, k, es):
    """Bytes and operations of the four fused convolution-module passes
    (statistics, forward, backward 1, backward 2), in that order."""
    n = b * t
    pre = 4 * (2 * d + 2 * e * d + 2 * e + k * e + e)
    full = pre + 4 * (2 * e + eo * e + eo)
    return ((n * d * es + pre + 8 * e, 4.0 * n * d * e + 2.0 * n * e * k),
            (n * d * es + full + 8 * e + n * eo * es, 2.0 * n * e * eo),
            (n * (d + eo) * es + full + 8 * e + 4 * (eo * e + eo + 2 * e),
             4.0 * n * e * eo),
            (n * (2 * d + eo) * es + full + 16 * e
             + 4 * (2 * d + 2 * e * d + 2 * e + k * e),
             8.0 * n * d * e + 4.0 * n * e * k))


def flash_cost(b, h, t, da, dv, lengths, es):
    """Bytes (q' read, the valid k'/v rows read, out and lse written) and
    operations (2 x T x len x (da + dv) per head) of one flash forward."""
    valid = int(np.sum(lengths))
    nbytes = (b * h * t * da * es + valid * h * (da + dv) * es
              + b * h * t * dv * es + b * h * t * 4 + b * 4)
    return nbytes, 2.0 * h * t * valid * (da + dv)


def stem_cost(frames, es):
    """The BN + ReLU + 3x3/2 pool kernel over (N, 44, 44, 64) conv
    frames: each input byte read once, (N, 22, 22, 64) written, 2 (64,)
    fp32 vectors; no product."""
    return frames * 64 * (44 * 44 + 22 * 22) * es + 2 * 64 * 4, 0.0


# ------------------------------------------------------------ model FLOPs
def _restride(t: int, s: int) -> int:
    return (t - 1) // s + 1


def _attention(b, t, d, heads=4):
    """q, k, v, out projections; the relative table (2T - 1 rows) through
    the positional projection; q against the table, q k^T, a v."""
    dh = d // heads
    return (8.0 * b * t * d * d + 2.0 * (2 * t - 1) * d * d
            + 2.0 * b * heads * t * (2 * t - 1) * dh
            + 4.0 * b * heads * t * t * dh)


def _stack(b, t, dims, num_blocks, interctc, kinds, vocab, k=15):
    flops = 0.0
    i = 0
    for stage, n in enumerate(num_blocks):
        d = dims[stage]
        for j in range(n):
            down = j == n - 1 and stage < len(num_blocks) - 1
            e = dims[stage + 1] if down else d
            s = 2 if down else 1
            t2 = _restride(t, s)
            flops += 2 * 2.0 * b * t * d * 4 * d           # ff1
            ta = -(-t // 3) if kinds[stage] == "patch" else t
            flops += _attention(b, ta, d)
            flops += 2.0 * b * t * d * 2 * e               # pw1
            flops += 2.0 * b * t2 * e * k                  # depthwise
            flops += 2.0 * b * t2 * e * e                  # pw2
            if e != d:
                flops += 2.0 * b * t2 * d * e              # strided shortcut
            flops += 2 * 2.0 * b * t2 * e * 4 * e          # ff2
            if i + 1 in interctc:
                flops += 4.0 * b * t2 * e * vocab
            t = t2
            i += 1
    return flops, t


def _audio(b, samples, spec):
    t = samples // 160 + 1
    flops = 2.0 * b * t * 257 * 80                         # mel filterbank
    t = _restride(t, 2)
    flops += 2.0 * b * 40 * t * 9 * 180                   # stem conv
    flops += 2.0 * b * t * 7200 * 180                      # stem linear
    kinds = ["patch" if spec["att_type"] == "patch" else "regular",
             "regular", "regular"]
    f, t = _stack(b, t, [180, 256, 360], spec["a_num_blocks"],
                  spec["a_interctc_blocks"], kinds, spec["vocab_size"])
    return flops + f, t


def _video(b, frames, spec):
    n = b * frames
    flops = 2.0 * n * 44 * 44 * 64 * 245                   # Conv3d stem
    hw, c = 22, 64
    for stage, dim in enumerate((64, 128, 256, 512)):
        for j in range(2):
            s = 2 if (j == 0 and stage > 0) else 1
            ho = _restride(hw, s)
            flops += 2.0 * n * ho * ho * dim * c * 9
            flops += 2.0 * n * ho * ho * dim * dim * 9
            if s != 1 or c != dim:
                flops += 2.0 * n * ho * ho * dim * c
            hw, c = ho, dim
    flops += 2.0 * n * 512 * 256                            # head
    f, _ = _stack(b, frames, [256, 360], spec["v_num_blocks"],
                  spec["v_interctc_blocks"], ["regular", "regular"],
                  spec["vocab_size"])
    return flops + f


def forward_flops(spec: dict, batch: int, samples: int, frames: int = 0
                  ) -> float:
    """Forward FLOPs of the model `spec` on a batch padded to `samples`
    audio samples (and `frames` video frames)."""
    fa, t = _audio(batch, samples, spec)
    if spec["kind"] == "ao":
        return fa + 2.0 * batch * t * 360 * spec["vocab_size"]
    fv = _video(batch, frames, spec)
    ff = 2.0 * batch * t * 720 * 1440 + 2.0 * batch * t * 1440 * 360
    fs, _ = _stack(batch, t, [360], [spec["f_num_blocks"]],
                   spec["f_interctc_blocks"], ["regular"],
                   spec["vocab_size"])
    return fa + fv + ff + fs + 2.0 * batch * t * 360 * spec["vocab_size"]


def kernel_bounds(calls: Sequence[Dict]) -> float:
    """Sum of the bound seconds of the recorded kernel calls; each call is
    {"kind", shape fields, "es", "backward"}."""
    total = 0.0
    for c in calls:
        kind, es = c["kind"], c["es"]
        if kind == "ffn":
            fb, fo, bb, bo = ffn_cost(c["n"], c["d"], c["f"], es)
            total += bound_s(fb, fo) + (bound_s(bb, bo) if c["backward"]
                                        else 0.0)
        elif kind == "att":
            fb, fo, bb, bo = att_cost(c["b"], c["t"], c["d"], c["heads"], es)
            total += bound_s(fb, fo) + (bound_s(bb, bo) if c["backward"]
                                        else 0.0)
        elif kind == "conv":
            passes = conv_cost(c["b"], c["t"], c["d"], c["e"], c["eo"],
                               c["k"], es)
            total += sum(bound_s(*p) for p in (passes if c["backward"]
                                               else passes[:2]))
        elif kind == "flash":
            lengths = np.asarray([int(v) for v in c["lengths"]])
            total += bound_s(*flash_cost(c["b"], c["h"], c["t"], c["da"],
                                         c["dv"], lengths, es))
        elif kind == "stem":
            total += bound_s(*stem_cost(c["frames"], es))
    return total
