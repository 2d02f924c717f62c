"""The port's matrix lowerings of the ADA warp (`rick_tpu_torch.augment.warp`,
chosen by `RICK_ADA_WARP`) against `rick_tpu`'s on the CPU.

* `matmul` and `matmul_fir`, forward and the gradient of sum(out * w) in
  the image, against rick_tpu's jitted `apply_affine` under the same
  `RICK_ADA_WARP`, at AFFINE_TOL (1e-4 of max|ref|);
* the 0.28x zoom-out tail, where `matmul_fir` clamps its taps: the port's
  follows rick_tpu's and parts from `gather` by O(1);
* the port's `matmul` against its `gather`: rick_tpu holds that pair
  bitwise, the port within 1e-6 of max|ref| (its row-then-column sums
  round in another order than gather's column-then-row blend);
* the tile size (`RICK_ADA_WARP_TILE` 8 and 32) does not change the result;
* with the variable unset the port runs `gather`, bitwise the chain it ran
  before the matrix lowerings were ported, and outside the tail that
  default matches rick_tpu's unset default (`matmul_fir`) at AFFINE_TOL;
* `_up2_matrix` bitwise against rick_tpu's.

Sizes and margins are those of `test_torch_augment.py`.
"""

import math

import numpy as np
import pytest
import torch

from rick_tpu.augment import warp as j_warp
from rick_tpu_torch.augment import ada, warp
from tests.test_torch_augment import AFFINE_TOL, CASES, _warp_cases, j_apply_affine, j_apply_affine_grad
from tests.torch_port_helpers import close, j, n, one_torch_thread, rand, t  # noqa: F401

LOWERINGS = ["matmul", "matmul_fir"]


def _tail_G():
    """0.28x zoom-outs, one rotated: |a| + |b| of G^-1's rows reaches 7.1,
    beyond the footprint's 2 sqrt 2."""
    G = np.tile(np.diag([0.28, 0.28, 1.0]).astype(np.float32), (2, 1, 1))
    G[1, :2, :2] = 0.28 * np.array([[math.cos(0.7), -math.sin(0.7)], [math.sin(0.7), math.cos(0.7)]])
    return G


def _port(img, G, margin, grad_w=None):
    """The port's apply_affine under the current RICK_ADA_WARP, and the
    gradient of sum(out * grad_w) in the image when grad_w is given."""
    x = t(img).requires_grad_(grad_w is not None)
    out = ada.apply_affine(x, t(G), margin=margin)
    if grad_w is None:
        return out.detach()
    (g,) = torch.autograd.grad((out * t(grad_w)).sum(), x)
    return out.detach(), g


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("size,margin", CASES)
def test_matrix_lowering_matches_rick_tpu(size, margin, lowering, monkeypatch):
    """Six transforms (four p = 1 draws, a rotation with a shift, a flip)
    under the same lowering on both sides: images and image gradients."""
    monkeypatch.setenv("RICK_ADA_WARP", lowering)
    G = _warp_cases(size)
    img, w = rand((len(G), 3, size, size), 3), rand((len(G), 3, size, size), 4)
    got, got_g = _port(img, G, margin, grad_w=w)
    close(got, j_apply_affine(margin)(j(img), j(G)), rtol=0, atol_frac=AFFINE_TOL)
    close(got_g, j_apply_affine_grad(margin)(j(img), j(G), j(w)), rtol=0, atol_frac=AFFINE_TOL)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_footprint_tail_matches_rick_tpus_lowering(lowering, monkeypatch):
    """In the 0.28x tail the port's matrix lowering follows rick_tpu's same
    lowering (images and gradients) and parts from gather by O(1)."""
    size, margin = 16, 44
    G = _tail_G()
    img, w = rand((2, 3, size, size), 6), rand((2, 3, size, size), 7)
    monkeypatch.setenv("RICK_ADA_WARP", lowering)
    got, got_g = _port(img, G, margin, grad_w=w)
    close(got, j_apply_affine(margin)(j(img), j(G)), rtol=0, atol_frac=AFFINE_TOL)
    close(got_g, j_apply_affine_grad(margin)(j(img), j(G), j(w)), rtol=0, atol_frac=AFFINE_TOL)
    monkeypatch.setenv("RICK_ADA_WARP", "gather")
    gathered = n(_port(img, G, margin))
    assert np.abs(n(got) - gathered).max() > 0.1 * np.abs(gathered).max()


@pytest.mark.parametrize("size,margin", CASES)
def test_matmul_equals_gather(size, margin, monkeypatch):
    """Outside the tail both read the same taps with the same weights: the
    images within 1e-6 of max|ref|, and the gradients too."""
    G = _warp_cases(size)
    img, w = rand((len(G), 3, size, size), 8), rand((len(G), 3, size, size), 9)
    monkeypatch.setenv("RICK_ADA_WARP", "gather")
    want, want_g = _port(img, G, margin, grad_w=w)
    monkeypatch.setenv("RICK_ADA_WARP", "matmul")
    got, got_g = _port(img, G, margin, grad_w=w)
    close(got, want, rtol=0, atol_frac=1e-6)
    close(got_g, want_g, rtol=0, atol_frac=1e-6)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_tile_size_does_not_change_the_result(lowering, monkeypatch):
    """RICK_ADA_WARP_TILE = 8 and 32 (the default, also when unset) give
    the same images within 1e-6 of max|ref|; the tail is excluded, as its
    clamped taps depend on the footprint."""
    size, margin = 32, 24
    G = _warp_cases(size)
    img = rand((len(G), 3, size, size), 10)
    monkeypatch.setenv("RICK_ADA_WARP", lowering)
    monkeypatch.delenv("RICK_ADA_WARP_TILE", raising=False)
    default = _port(img, G, margin)
    monkeypatch.setenv("RICK_ADA_WARP_TILE", "32")
    assert torch.equal(_port(img, G, margin), default)
    monkeypatch.setenv("RICK_ADA_WARP_TILE", "8")
    close(_port(img, G, margin), default, rtol=0, atol_frac=1e-6)


def _gather_chain(img, G, margin):
    """apply_affine as the port ran it before the matrix lowerings: reflect
    pad, up2-FIR, the gather sampler, down2."""
    from rick_tpu_torch.ops.resample import upfirdn2d_separable

    k = ada._const("sym6", img)
    B, C, h_o, w_o = img.shape
    M = margin
    img_2x = upfirdn2d_separable(ada._reflect101_pad(img, M + 6), torch.flip(k, (0,)), up=2)
    H2, W2 = img_2x.shape[2:]
    w_p, h_p = w_o + 2 * M + 1, h_o + 2 * M + 1
    Lh, Lw = 2 * h_o + 10, 2 * w_o + 10
    gx = ada._grid(-2.0 * M / w_o - 1.0, 2.0 * (w_p - M) / w_o - 1.0, W2, 2 * M, Lw, img.device)[None, None, :]
    gy = ada._grid(-2.0 * M / h_o - 1.0, 2.0 * (h_p - M) / h_o - 1.0, H2, 2 * M, Lh, img.device)[None, :, None]
    gi = ada._inv3(G)[:, :, :, None, None]
    xp = (gi[:, 0, 0] * gx + gi[:, 0, 1] * gy + gi[:, 0, 2]) * (w_o / w_p) + ((w_o + 2.0 * M) / w_p - 1.0)
    yp = (gi[:, 1, 0] * gx + gi[:, 1, 1] * gy + gi[:, 1, 2]) * (h_o / h_p) + ((h_o + 2.0 * M) / h_p - 1.0)
    x_pix, y_pix = (xp + 1.0) * W2 / 2.0 - 0.5, (yp + 1.0) * H2 / 2.0 - 0.5
    return upfirdn2d_separable(ada._bilinear_sample_reflect(img_2x, x_pix, y_pix), k, down=2)


@pytest.mark.parametrize("size,margin", CASES)
def test_unset_variable_keeps_the_gather_chain_bitwise(size, margin, monkeypatch):
    """Unset, 'gather' and an unknown value all run the gather chain,
    bitwise; the tail included."""
    G = np.concatenate([_warp_cases(size), _tail_G()])
    img = rand((len(G), 3, size, size), 11)
    want = _gather_chain(t(img), t(G), margin)
    monkeypatch.delenv("RICK_ADA_WARP", raising=False)
    assert torch.equal(_port(img, G, margin), want)
    for value in ("gather", "other"):
        monkeypatch.setenv("RICK_ADA_WARP", value)
        assert torch.equal(_port(img, G, margin), want)


@pytest.mark.parametrize("size,margin", CASES)
def test_unset_default_matches_rick_tpus_default(size, margin, monkeypatch):
    """Both packages with RICK_ADA_WARP unset: the port's gather against
    rick_tpu's matmul_fir, images and image gradients, at AFFINE_TOL; the
    tail is excluded (ROADMAP queue 3: the two defaults part there)."""
    monkeypatch.delenv("RICK_ADA_WARP", raising=False)
    G = _warp_cases(size)
    img, w = rand((len(G), 3, size, size), 12), rand((len(G), 3, size, size), 13)
    got, got_g = _port(img, G, margin, grad_w=w)
    close(got, j_apply_affine(margin)(j(img), j(G)), rtol=0, atol_frac=AFFINE_TOL)
    close(got_g, j_apply_affine_grad(margin)(j(img), j(G), j(w)), rtol=0, atol_frac=AFFINE_TOL)


@pytest.mark.parametrize("n_in", [7, 40, 74])
def test_up2_matrix_bitwise(n_in):
    k = np.flip(np.asarray(ada.SYM6, np.float32)).copy()
    got = warp._up2_matrix(n_in, k.tobytes())
    want = j_warp._up2_matrix(n_in, k.tobytes())
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
