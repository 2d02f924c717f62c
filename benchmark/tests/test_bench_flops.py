"""The FLOP counter against hand counts, and the committed FLOP data against
the counter."""

import json

import pytest
import torch

from benchmark import flops, spec
from benchmark.reference import stylegan2


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_linear_layer():
    with torch.device("meta"):
        layer = stylegan2.EqualLinear(512, 256)
    assert flops.count(lambda: layer(_meta(8, 512))) == 2 * 8 * 512 * 256


def test_modulated_conv():
    b, cin, cout, h, s = 2, 64, 32, 8, 512
    with torch.device("meta"):
        conv = stylegan2.ModulatedConv2d(cin, cout, 3, s)
    got = flops.count(lambda: conv(_meta(b, cin, h, h), _meta(b, s)))
    # the 3x3 conv, the style's linear layer, demod's (B, Cin) x (Cin, Cout) product
    assert got == 2 * b * cin * cout * 9 * h * h + 2 * b * s * cin + 2 * b * cin * cout


def test_transposed_conv():
    b, cin, cout, h, s = 2, 64, 32, 8, 512
    with torch.device("meta"):
        conv = stylegan2.ModulatedConv2d(cin, cout, 3, s, upsample=True)
    got = flops.count(lambda: conv(_meta(b, cin, h, h), _meta(b, s)))
    convt = 2 * b * cin * cout * 9 * h * h  # roofline.convt_ops: 9 taps of Cin per input pixel and output channel
    blur = 2 * b * cout * 16 * (2 * h) ** 2  # the 4x4 FIR over each output channel
    assert got == convt + blur + 2 * b * s * cin + 2 * b * cin * cout


def test_backward_counts_twice_the_forward():
    with torch.device("meta"):
        layer = stylegan2.EqualLinear(128, 64)
    x = _meta(4, 128).requires_grad_(True)
    total = flops.count(lambda: torch.autograd.grad(layer(x).sum(), [x, layer.weight]))
    assert total == 3 * (2 * 4 * 128 * 64)


@pytest.mark.parametrize("cell", [w for w in spec.load_benchmark()["workloads"]], ids=lambda w: w["name"])
def test_committed_counts_are_the_counter(cell):
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    got = flops.KINDS[traffic["kind"]](cfg, traffic)
    assert got == json.loads((spec.ROOT / "flops" / f"{cell['config']}.{cell['traffic']}.json").read_text())
