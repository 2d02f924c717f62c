"""Parity of `rick_tpu_torch.ops` resampling and activation with `rick_tpu.ops`
and the numpy upfirdn2d oracle, on identical numpy inputs."""

import numpy as np
import pytest
import torch

from rick_tpu.ops import fused_act as jfa
from rick_tpu.ops import resample as jrs
from rick_tpu_torch.ops import fused_act as tfa
from rick_tpu_torch.ops import resample as trs
from tests.torch_port_helpers import close, j, n, one_torch_thread, rand, t  # noqa: F401

# f32 sums of at most 16 products: a few ulps apart from the f64 oracle
RTOL = 1e-5
ATOL_FRAC = 1e-6

# (up_x, up_y, down_x, down_y, pad_x0, pad_x1, pad_y0, pad_y1, kernel shape)
UPFIRDN_CASES = {
    "blur_pad": (1, 1, 1, 1, 1, 2, 1, 2, (4, 4)),
    "up2": (2, 2, 1, 1, 2, 1, 2, 1, (4, 4)),
    "down2": (1, 1, 2, 2, 1, 1, 1, 1, (4, 4)),
    "up2_down2": (2, 2, 2, 2, 0, 0, 0, 0, (3, 3)),
    "negative_pad_crop": (1, 1, 1, 1, -1, 2, 1, -2, (3, 3)),
    "crop_both_x_sides": (1, 1, 1, 1, -1, -2, 0, 0, (3, 3)),
    "per_axis_mixed": (2, 1, 1, 2, 1, -1, 2, 0, (3, 4)),
    # JAX on the CPU returns wrong values (up to 1e36) for this pad pattern
    # at this shape: the lax conv with a negative low and a positive high pad
    # on H.  Checked against the oracle only.
    "crop_top_pad_bottom": (1, 1, 1, 1, 0, 0, -2, 1, (3, 3)),
}
ORACLE_ONLY = {"crop_top_pad_bottom"}


@pytest.mark.parametrize("case", list(UPFIRDN_CASES), ids=list(UPFIRDN_CASES))
def test_upfirdn2d_general_matches_oracle_and_jax(case):
    *factors, kshape = UPFIRDN_CASES[case]
    x = rand((2, 3, 9, 8), 1)
    k = rand(kshape, 2)  # asymmetric: a missed flip changes the result
    want = jrs.upfirdn2d_numpy_oracle(x, k, *factors)
    got = trs.upfirdn2d_general(t(x), t(k), *factors)
    close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)
    if case not in ORACLE_ONLY:
        close(got, jrs.upfirdn2d_general(j(x), j(k), *factors), rtol=RTOL, atol_frac=ATOL_FRAC)


def test_upfirdn2d_symmetric_api_matches_jax():
    x, k = rand((1, 4, 7, 7), 3), rand((4, 4), 4)
    got = trs.upfirdn2d(t(x), t(k), up=2, down=1, pad=(2, 1))
    close(got, jrs.upfirdn2d(j(x), j(k), up=2, down=1, pad=(2, 1)), rtol=RTOL, atol_frac=ATOL_FRAC)


def test_upfirdn2d_empty_output_raises():
    with pytest.raises(ValueError):
        trs.upfirdn2d(t(rand((1, 1, 2, 2), 0)), t(rand((4, 4), 1)), pad=(-1, -1))


def test_upfirdn2d_separable_matches_2d_and_jax():
    x, k1 = rand((2, 3, 8, 8), 5), np.array([1.0, 3.0, 2.0, 1.0], np.float32)
    got = trs.upfirdn2d_separable(t(x), k1, up=2, pad=(2, 1))
    close(got, trs.upfirdn2d(t(x), t(np.outer(k1, k1)), up=2, pad=(2, 1)), rtol=RTOL, atol_frac=ATOL_FRAC)
    close(got, jrs.upfirdn2d_separable(j(x), k1, up=2, pad=(2, 1)), rtol=RTOL, atol_frac=ATOL_FRAC)


@pytest.mark.parametrize("kernel", [(1, 3, 3, 1), (1, 2, 1)], ids=["4tap", "3tap"])
def test_make_kernel_matches_jax(kernel):
    close(trs.make_kernel(kernel), jrs.make_kernel(kernel), rtol=1e-7, atol_frac=0)


RESAMPLE_CASES = {
    "upsample2d": lambda m, x: m.upsample2d(x, (1, 3, 3, 1), factor=2),
    "downsample2d": lambda m, x: m.downsample2d(x, (1, 3, 3, 1), factor=2),
    "blur_down_pad": lambda m, x: m.blur(x, (1, 3, 3, 1), pad=(2, 1)),
    "blur_after_convt": lambda m, x: m.blur(x, (1, 3, 3, 1), pad=(1, 1), upsample_factor=2),
}


@pytest.mark.parametrize("op", list(RESAMPLE_CASES), ids=list(RESAMPLE_CASES))
def test_resample_ops_match_jax(op):
    x = rand((2, 5, 12, 12), 6)
    got = RESAMPLE_CASES[op](trs, t(x))
    close(got, RESAMPLE_CASES[op](jrs, j(x)), rtol=RTOL, atol_frac=ATOL_FRAC)


def test_upfirdn2d_twice_differentiable():
    """An R1-style penalty differentiates through the resample twice."""
    x = torch.tensor(rand((1, 2, 5, 5), 7), dtype=torch.float64, requires_grad=True)
    k = trs.make_kernel((1, 3, 3, 1)).double()
    assert torch.autograd.gradgradcheck(lambda x: trs.upfirdn2d(x, k, up=2, pad=(2, 1)), (x,))


ACT_SHAPES = {"2d": (4, 32), "4d": (2, 8, 5, 5), "3d": (3, 6, 7)}


@pytest.mark.parametrize("shape", list(ACT_SHAPES), ids=list(ACT_SHAPES))
def test_fused_leaky_relu_matches_jax(shape):
    shape = ACT_SHAPES[shape]
    x = rand(shape, 8)
    b = rand((shape[-1] if len(shape) == 2 else shape[1],), 9)
    close(tfa.fused_leaky_relu(t(x), t(b)), jfa.fused_leaky_relu(j(x), j(b)), rtol=RTOL, atol_frac=0)
    close(tfa.fused_leaky_relu(t(x)), jfa.fused_leaky_relu(j(x)), rtol=RTOL, atol_frac=0)


def test_scaled_and_kml_variants_match_jax():
    x, b, v = rand((2, 4, 3, 3), 10), rand((4,), 11), rand((4,), 12)
    close(tfa.scaled_leaky_relu(t(x)), jfa.scaled_leaky_relu(j(x)), rtol=RTOL, atol_frac=0)
    close(tfa.fused_leaky_relu_kml(t(x), t(b), t(v)), jfa.fused_leaky_relu_kml(j(x), j(b), j(v)),
          rtol=RTOL, atol_frac=0)
    close(tfa.fused_leaky_relu_kml(t(x), t(b)), jfa.fused_leaky_relu_kml(j(x), j(b)), rtol=RTOL, atol_frac=0)


def test_fused_leaky_relu_derivatives():
    """dy/dx is sqrt(2) or 0.2*sqrt(2); d2y/dx2 == 0 away from the kink."""
    x = torch.tensor(rand((3, 4), 13) + 0.05, requires_grad=True)
    b = t(rand((4,), 14))
    (gx,) = torch.autograd.grad(tfa.fused_leaky_relu(x, b).sum(), x)
    want = np.where(n(x) + n(b) >= 0, 1.0, 0.2) * 2**0.5
    close(gx, want, rtol=1e-6, atol_frac=0)
    hess = torch.autograd.functional.hessian(lambda v: tfa.fused_leaky_relu(v, b).sum(), x)
    assert not torch.any(hess)
