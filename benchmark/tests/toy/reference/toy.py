"""The plain reference of the toy family (`families/toy.py`), in plain
`torch` over the reference's filterbank; it imports nothing of the
program."""

import torch
import torch.nn.functional as F

from benchmark.reference.model import fbank, linear


def forward(ctx, P, B, spec, inputs):
    audio, alen = inputs
    x, lengths = fbank(audio.float(), alen)
    b, _, t = x.shape
    s = spec["stack"]
    x = F.pad(x.transpose(1, 2), (0, 0, 0, -t % s)).reshape(b, -1, 80 * s)
    for name in ("layers.0", "layers.1"):
        x = torch.relu(linear(ctx, P, name, x))
    return {"outputs": (linear(ctx, P, "head", x),
                        torch.div(lengths - 1, s, rounding_mode="floor") + 1)}
