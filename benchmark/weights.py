"""Seeded weights on the device, in a few large calls: every entry of the
model's state dict gets its slice of one normal draw (matrices and
convolutions scaled by 1 / sqrt(fan in), the ResNet trunk's bias-free
convolutions by sqrt(2 / fan in), biases by 0.02) or a constant (norm
scales 1); running means 0.1 N(0, 1), running variances U(0.5, 1.5)."""

from typing import Dict

import torch


def make_state(shapes: Dict[str, tuple], seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} for a state dict's (name, shape)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = [k for k, s in shapes.items()
              if not (k.endswith("running_var")
                      or (len(s) == 1 and k.endswith(".weight")))]
    sizes = [int(torch.Size(shapes[k]).numel()) for k in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(normal, flat.split(sizes)):
        s = shapes[k]
        if k.endswith("running_mean"):
            scale = 0.1
        elif len(s) == 1:
            scale = 0.02
        else:
            fan_in = int(torch.Size(s[1:]).numel())
            gain = 2.0 if (".front_end.3." in k and len(s) == 4) else 1.0
            scale = (gain / fan_in) ** 0.5
        out[k] = part.view(s).mul_(scale)
    var = [k for k in shapes if k.endswith("running_var")]
    vsizes = [int(torch.Size(shapes[k]).numel()) for k in var]
    if var:
        u = torch.rand(sum(vsizes), generator=gen, device=device).add_(0.5)
        out.update({k: p.view(shapes[k])
                    for k, p in zip(var, u.split(vsizes))})
    for k, s in shapes.items():
        if k not in out:
            out[k] = torch.ones(s, device=device)
    return {k: out[k] for k in shapes}
