"""The copied roofline arithmetic against the port's `tools/roofline.py` and
against the bounds PERF.md's kernel table gives at K1-K4's main-path shapes."""

import pytest

from benchmark import roofline
from rick_tpu_torch.tools import roofline as port_roofline

# (entry point, arguments as the wrapper passes them, the bound in ms PERF.md gives)
CASES = [
    # K1 at (4,128,256,256): x, bias, y, n, C, inner, slope, scale, stream
    ("rick_fused_bias_act", (0, 0, 0, 4 * 128 * 256 * 256, 128, 256 * 256, 0.2, 1.41, 0), 0.0801),
    # K2 at (2,128,256,256) with bias: g, y, bias, out, n, C, inner, slope, scale, stream
    ("rick_fused_bias_act_bwd", (0, 0, 1, 0, 2 * 128 * 256 * 256, 128, 256 * 256, 0.2, 1.41, 0), 0.0601),
    # K3 at (4,128,256,256), noise batch 4: out, demod, noise, nw, bias, y, B, C, HW, batched, ...
    ("rick_modconv_epilogue", (0, 0, 0, 0, 0, 0, 4, 128, 256 * 256, 1, 0.2, 1.41, 0), 0.0804),
    # K4 at (4,256,128,128) -> 128: xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, batched, ...
    ("rick_convt_blur_act_stage", (0, 0, 0, 0, 0, 0, 4, 256, 128, 128, 128, 1) + (0.0,) * 4 + (1, 0.2, 1.41, 3, 0),
     0.234),
]


@pytest.mark.parametrize("fn,args,perf_ms", CASES, ids=[c[0] for c in CASES])
def test_launch_bound_matches_the_kernel_table(fn, args, perf_ms):
    assert roofline.launch_bound(fn, args) == pytest.approx(perf_ms, abs=5e-4)


@pytest.mark.parametrize("nbytes,f32,tf32,launch", [(2.68e8, 1e8, 0, 0), (1e6, 1e12, 0, 0), (1e6, 0, 3.6e11, 0),
                                                   (1e3, 1e3, 0, 0.004)])
def test_bound_is_the_port_arithmetic(nbytes, f32, tf32, launch):
    assert roofline.bound(nbytes, f32, tf32, launch) == port_roofline.bound(nbytes, f32, tf32, launch)


def test_byte_and_operation_counts_are_the_port_arithmetic():
    assert roofline.convt_ops(4, 256, 128, 128) == port_roofline.convt_ops(4, 256, 128, 128)
    assert roofline.fused_bias_act_bytes(1000, 10) == port_roofline.fused_bias_act_bytes(1000, 10)
    assert roofline.modconv_epilogue_bytes(2, 512, 16, 1) == port_roofline.modconv_epilogue_bytes(2, 512, 16, 1)
    assert roofline.PEAK_TF32_FLOP_PER_S == port_roofline.PEAK_TF32_FLOP_PER_S == 495e12
