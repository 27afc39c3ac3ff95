"""The yardstick's arithmetic that every model family shares: the card's
peaks and the bytes and operations a hand-written kernel call needs (copied
from the port's proof script, with the stem kernel's added). A family's
model FLOPs are its own (`families/<family>.py:forward_flops`); a training
step counts 3 forwards, no recompute.

A kernel's bound is the larger of its bytes over the HBM bandwidth and its
operations over the bf16 tensor-core peak.
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
