"""The benchmark's model FLOPs against torch's FlopCounterMode on the plain
reference, and the kernel cost arithmetic's bounds."""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import costs, weights  # noqa: E402
from benchmark.families import avec  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402

SPECS = {
    "av": dict(kind="av", vocab_size=32, v_num_blocks=[1, 2],
               a_num_blocks=[2, 1, 1], f_num_blocks=2, v_interctc_blocks=[1],
               a_interctc_blocks=[2, 4], f_interctc_blocks=[1],
               att_type="patch"),
    "ao": dict(kind="ao", vocab_size=40, a_num_blocks=[1, 2, 1],
               a_interctc_blocks=[3], att_type="patch"),
    "ao_regular": dict(kind="ao", vocab_size=40, a_num_blocks=[1, 1, 1],
                       a_interctc_blocks=[], att_type="regular"),
}
ROUTE = dict(fused_ffn=True, fused_att=True, fused_conv=True,
             stem_mode="pallas", use_flash=False)


@pytest.mark.parametrize("name,batch,samples", [
    ("av", 2, 12800), ("av", 3, 9000), ("ao", 2, 16000), ("ao", 1, 7777),
    ("ao_regular", 2, 11000)])
def test_forward_flops_match_the_counter(name, batch, samples):
    spec = SPECS[name]
    model, state = avec.build_model(spec, ROUTE, 1, torch.device("cpu"))
    names = {n for n, _ in model.named_parameters()}
    P = {k: v for k, v in state.items() if k in names}
    B = {k: v for k, v in state.items() if k not in names}
    frames = samples // 640 + 1
    audio = torch.randn(batch, samples) * 0.1
    alen = torch.full((batch,), samples)
    inputs = [audio, alen]
    if spec["kind"] == "av":
        inputs = [torch.rand(batch, frames, 88, 88, 1),
                  torch.full((batch,), frames)] + inputs
    with FlopCounterMode(display=False) as counter:
        avec.reference_forward(ref.Ctx(False), P, B, spec, inputs)
    want = counter.get_total_flops()
    got = avec.forward_flops(spec, batch, samples, frames)
    assert got == pytest.approx(want, rel=1e-9)


def test_bounds_take_the_larger_side():
    nbytes, ops = costs.HBM_BYTES_PER_S, costs.PEAK_OPS["bf16"] * 2
    assert costs.bound_s(nbytes, ops) == pytest.approx(2.0)
    assert costs.bound_s(nbytes * 3, ops) == pytest.approx(3.0)
    calls = [dict(kind="ffn", n=100, d=8, f=32, es=2, backward=False),
             dict(kind="stem", frames=4, es=2, backward=False)]
    total = costs.kernel_bounds(calls)
    fb, fo, _, _ = costs.ffn_cost(100, 8, 32, 2)
    assert total == pytest.approx(costs.bound_s(fb, fo)
                                  + costs.bound_s(*costs.stem_cost(4, 2)))


def test_weights_cover_every_state_entry():
    model, state = avec.build_model(SPECS["ao"], ROUTE, 2,
                                    torch.device("cpu"))
    assert set(state) == set(model.state_dict())
    again = weights.make_state({k: tuple(v.shape) for k, v in state.items()},
                               2, "cpu")
    assert all(torch.equal(again[k], state[k]) for k in state)
