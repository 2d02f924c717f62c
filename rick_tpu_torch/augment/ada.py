"""ADA ("non-leaking") augmentation.  Port of `rick_tpu/augment/ada.py`.

The geometric pipeline is the reference's (`non_leaking.py:316-371`) at a
static margin M: reflect-pad by M + 6 (the sym6 support), antialias
2x-upsample with the sym6 wavelet, bilinear sample at the inverse-affine
grid with coordinate reflection, 2x-downsample.  Only the rows and columns
of the grid that survive the final crop are evaluated, so the warp's cost
does not grow with M; the FIR pair's does, as (size + 2M)^2.  With G = I the
pipeline returns the input up to rounding (sym6 is orthogonal), which pins
every offset of the coordinate bookkeeping.

The warp has rick_tpu's three lowerings, chosen by `RICK_ADA_WARP` on
every call (`_warp_mode`).  The default, `gather`, is the direct
`grid_sample` transcription: the four bilinear taps are one `torch.gather`
over the flattened 2x image, and the backward, by autograd, is a
scatter-add into it followed by the FIR's transposed convolution.
`matmul` runs the same taps as tiled interpolation matrix products over
the 2x image, and `matmul_fir` folds the up2-FIR into those matrices and
never builds the 2x image (`augment/warp.py`).  rick_tpu's default is
`matmul_fir`, chosen on the TPU; the port keeps `gather`.  Where G^-1
shrinks the image by more than 2x (|a| + |b| of a row of G^-1 above
2 sqrt 2), the matrix lowerings clamp their taps to a footprint and part
from `gather`; the samplers never draw such a G in practice.

Every random number comes from a `torch.Generator` on its device, and `p`
is a 0-d tensor on that device (the training state's `ada_p`): nothing is
read back to the host.  Each sampler is a draw function and a composer
(`affine_draws` / `affine_from_draws`, `color_draws` / `color_from_draws`),
so that a test can hand the composer the draws another framework made.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rick_tpu_torch.augment.warp import _reflect_coord, warp_bilinear_matmul, warp_bilinear_matmul_fir
from rick_tpu_torch.ops.resample import upfirdn2d_separable

# sym6 wavelet taps (`non_leaking.py:9-22`)
SYM6 = (
    0.015404109327027373,
    0.0034907120842174702,
    -0.11799011114819057,
    -0.048311742585633,
    0.4910559419267466,
    0.787641141030194,
    0.3379294217276218,
    -0.07263752278646252,
    -0.021060292512300564,
    0.04472490177066578,
    0.0017677118642428036,
    -0.007800708325034148,
)


def _warp_mode() -> str:
    """The bilinear warp's lowering, `RICK_ADA_WARP`: 'matmul_fir', 'matmul',
    or anything else (default) for 'gather'."""
    return os.environ.get("RICK_ADA_WARP", "gather")


StepDraws = Dict[str, torch.Tensor]  # per step's name, its draws; 'select': the Bernoulli uniforms


# ---------------------------------------------------------------------------
# Random matrix sampling (`non_leaking.py:25-241`)
# ---------------------------------------------------------------------------


def _eye(n: int, b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=like.device).repeat(b, 1, 1)


def _translate_mat(t_x, t_y):
    m = _eye(3, t_x.shape[0], t_x)
    m[:, 0, 2] = t_x
    m[:, 1, 2] = t_y
    return m


def _rotate_mat(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def _scale_mat(s_x, s_y):
    m = _eye(3, s_x.shape[0], s_x)
    m[:, 0, 0] = s_x
    m[:, 1, 1] = s_y
    return m


def _translate3d_mat(t):
    m = _eye(4, t.shape[0], t)
    m[:, 0, 3] = t
    m[:, 1, 3] = t
    m[:, 2, 3] = t
    return m


def _scale3d_mat(s):
    m = _eye(4, s.shape[0], s)
    m[:, 0, 0] = s
    m[:, 1, 1] = s
    m[:, 2, 2] = s
    return m


_AXIS = np.full((3,), 1.0 / math.sqrt(3.0), np.float32)
_AXIS4 = np.concatenate([_AXIS, [0.0]]).astype(np.float32)
_OUTER4 = np.outer(_AXIS4, _AXIS4)
# the rotation about the (1,1,1)/sqrt(3) axis: c * I + s * cross + (1 - c) * outer
_CROSS3 = np.array([(0, -_AXIS[2], _AXIS[1]), (_AXIS[2], 0, -_AXIS[0]), (-_AXIS[1], _AXIS[0], 0)], np.float32)
_OUTER3 = np.outer(_AXIS, _AXIS).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    """The constant tensors on `device`, copied there once: a copy from the
    host per call would wait for the device each time."""
    host = {"outer4": _OUTER4, "cross3": _CROSS3, "outer3": _OUTER3, "sym6": np.asarray(SYM6, np.float32)}
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in host.items()}


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    return _consts(like.device)[name]


def _luma_flip_mat(i):
    flip = 2.0 * _const("outer4", i)[None] * i[:, None, None]
    return torch.eye(4, dtype=torch.float32, device=i.device)[None] - flip


def _saturation_mat(i):
    outer = _const("outer4", i)[None]
    return outer + (torch.eye(4, dtype=torch.float32, device=i.device)[None] - outer) * i[:, None, None]


def _rotate3d_mat(theta):
    """Rotation about the (1,1,1)/sqrt(3) axis (`non_leaking.py:67-85`)."""
    s = torch.sin(theta)[:, None, None]
    c = torch.cos(theta)[:, None, None]
    eye3 = torch.eye(3, dtype=torch.float32, device=theta.device)[None]
    rot = c * eye3 + s * _const("cross3", theta)[None] + (1 - c) * _const("outer3", theta)[None]
    m = _eye(4, theta.shape[0], theta)
    m[:, :3, :3] = rot
    return m


def _random_apply(select_u, p, transform, prev):
    """With probability p (select_u < p, per image) apply `transform` before
    `prev`: (sel * transform + (1 - sel) * I) @ prev."""
    select = (select_u < p).to(torch.float32)[:, None, None]
    eye = torch.eye(transform.shape[-1], dtype=torch.float32, device=transform.device)[None]
    return (select * transform + (1 - select) * eye) @ prev


def _uniform(gen: torch.Generator, size: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand((size,), generator=gen, device=gen.device) * (hi - lo) + lo


def _normal(gen: torch.Generator, size: int) -> torch.Tensor:
    return torch.randn((size,), generator=gen, device=gen.device)


def _bit(gen: torch.Generator, size: int) -> torch.Tensor:
    return torch.randint(0, 2, (size,), generator=gen, device=gen.device).to(torch.float32)


# the eight steps of `sample_affine`, in order; each has its own Bernoulli draw
AFFINE_STEPS = ("flip", "rot90", "translate", "scale", "pre_rotate", "aniso", "post_rotate", "frac_translate")
COLOR_STEPS = ("brightness", "contrast", "luma_flip", "hue", "saturation")


def affine_draws(gen: torch.Generator, size: int) -> StepDraws:
    """The random numbers of `sample_affine` for `size` images, on `gen`'s
    device: per step its parameter draw, and `select`, (8, size) uniforms
    for the steps' Bernoulli tests.  Flip and rot90 are 0/1; translate is
    uniform in [-1/8, 1/8); the rotations uniform in [-pi, pi); the scales
    and the fractional translate standard normals."""
    return {
        "flip": _bit(gen, size),
        "rot90": _bit(gen, size),
        "translate": _uniform(gen, size, -0.125, 0.125),
        "scale": _normal(gen, size),
        "pre_rotate": _uniform(gen, size, -math.pi, math.pi),
        "aniso": _normal(gen, size),
        "post_rotate": _uniform(gen, size, -math.pi, math.pi),
        "frac_translate": _normal(gen, size),
        "select": torch.rand((len(AFFINE_STEPS), size), generator=gen, device=gen.device),
    }


def affine_from_draws(draws: StepDraws, p: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The per-image 3x3 affine of `sample_affine` (`non_leaking.py:151-207`)
    from `affine_draws`.  The rotations fire with 1 - sqrt(1 - p), the other
    steps with p."""
    d, u = draws, draws["select"]
    size = d["flip"].shape[0]
    p_rot = 1 - torch.sqrt(torch.clamp(1 - p, 0.0, 1.0))
    lognormal = lambda n: torch.exp(n * (0.2 * math.log(2)))  # noqa: E731
    G = _eye(3, size, d["flip"])
    G = _random_apply(u[0], p, _scale_mat(1 - 2.0 * d["flip"], torch.ones_like(d["flip"])), G)
    G = _random_apply(u[1], p, _rotate_mat(-math.pi / 2 * (3.0 * d["rot90"])), G)
    ph = torch.round(d["translate"] * height) / height
    pw = torch.round(d["translate"] * width) / width
    G = _random_apply(u[2], p, _translate_mat(pw, ph), G)
    s = lognormal(d["scale"])
    G = _random_apply(u[3], p, _scale_mat(s, s), G)
    G = _random_apply(u[4], p_rot, _rotate_mat(-d["pre_rotate"]), G)
    s = lognormal(d["aniso"])
    G = _random_apply(u[5], p, _scale_mat(s, 1 / s), G)
    G = _random_apply(u[6], p_rot, _rotate_mat(-d["post_rotate"]), G)
    t = d["frac_translate"] * 0.125  # the same shift on both axes, as in the reference
    return _random_apply(u[7], p, _translate_mat(t, t), G)


def sample_affine(gen: torch.Generator, p: torch.Tensor, size: int, height: int, width: int) -> torch.Tensor:
    """Random per-image 3x3 affines, (size, 3, 3), on `gen`'s device."""
    return affine_from_draws(affine_draws(gen, size), p, height, width)


def color_draws(gen: torch.Generator, size: int) -> StepDraws:
    """The random numbers of `sample_color`: brightness, contrast and
    saturation standard normals, the luma flip 0/1, the hue rotation uniform
    in [-pi, pi), and `select`, (5, size) uniforms."""
    return {
        "brightness": _normal(gen, size),
        "contrast": _normal(gen, size),
        "luma_flip": _bit(gen, size),
        "hue": _uniform(gen, size, -math.pi, math.pi),
        "saturation": _normal(gen, size),
        "select": torch.rand((len(COLOR_STEPS), size), generator=gen, device=gen.device),
    }


def color_from_draws(draws: StepDraws, p: torch.Tensor) -> torch.Tensor:
    """The per-image 4x4 colour matrix of `sample_color`
    (`non_leaking.py:210-241`) from `color_draws`."""
    d, u = draws, draws["select"]
    C = _eye(4, d["brightness"].shape[0], d["brightness"])
    C = _random_apply(u[0], p, _translate3d_mat(d["brightness"] * 0.2), C)
    C = _random_apply(u[1], p, _scale3d_mat(torch.exp(d["contrast"] * (0.5 * math.log(2)))), C)
    C = _random_apply(u[2], p, _luma_flip_mat(d["luma_flip"]), C)
    C = _random_apply(u[3], p, _rotate3d_mat(d["hue"]), C)
    return _random_apply(u[4], p, _saturation_mat(torch.exp(d["saturation"] * (1.0 * math.log(2)))), C)


def sample_color(gen: torch.Generator, p: torch.Tensor, size: int) -> torch.Tensor:
    """Random per-image 4x4 colour matrices, (size, 4, 4), on `gen`'s device."""
    return color_from_draws(color_draws(gen, size), p)


# ---------------------------------------------------------------------------
# Geometric application (`non_leaking.py:316-371`), static-shape version
# ---------------------------------------------------------------------------


def _bilinear_sample_reflect(img, x_pix, y_pix):
    """Bilinear sample img (B, C, H, W) at continuous pixel coords (B, Ho, Wo),
    reflecting out-of-range coordinates.  The four taps are one gather over
    the flattened image."""
    B, C, H, W = img.shape
    x = _reflect_coord(x_pix, W)
    y = _reflect_coord(y_pix, H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    idx = torch.stack([y0i * W + x0i, y0i * W + x1i, y1i * W + x0i, y1i * W + x1i], dim=1)  # (B, 4, Ho, Wo)
    taps = torch.gather(img.reshape(B, C, H * W), 2, idx.reshape(B, 1, -1).expand(B, C, -1))
    v00, v01, v10, v11 = taps.reshape((B, C) + idx.shape[1:]).unbind(2)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _reflect101_pad(img, pad: int):
    """Reflect-pad (edge pixel not duplicated, as F.pad mode='reflect') by
    any `pad`, through an index gather: it holds for pad >= size too, where
    F.pad raises (the cause of the reference's retry loop,
    `non_leaking.py:301-311`), and content beyond one mirror period is the
    next mirror image."""
    B, C, H, W = img.shape

    def refl_idx(n: int):
        i = torch.arange(-pad, n + pad, device=img.device)
        period = 2 * (n - 1) if n > 1 else 1
        m = torch.remainder(i.abs(), period)
        return torch.where(m < n, m, period - m)

    return img[:, :, refl_idx(H), :][:, :, :, refl_idx(W)]


def _inv3(G: torch.Tensor) -> torch.Tensor:
    """Inverses of a batch of 3x3 matrices by the adjugate: no host check
    for singular input (a singular G gives non-finite entries)."""
    a, b, c = G[:, 0, 0], G[:, 0, 1], G[:, 0, 2]
    d, e, f = G[:, 1, 0], G[:, 1, 1], G[:, 1, 2]
    g, h, i = G[:, 2, 0], G[:, 2, 1], G[:, 2, 2]
    adj = torch.stack([
        e * i - f * h, c * h - b * i, b * f - c * e,
        f * g - d * i, a * i - c * g, c * d - a * f,
        d * h - e * g, b * g - a * h, a * e - b * d,
    ], dim=1).reshape(-1, 3, 3)
    det = a * adj[:, 0, 0] + b * adj[:, 1, 0] + c * adj[:, 2, 0]
    return adj / det[:, None, None]


def _grid(lo: float, hi: float, num: int, start: int, length: int, device) -> torch.Tensor:
    """Entries [start, start + length) of linspace(lo, hi, num), each
    rounded once to f32 (computed in f64)."""
    return torch.linspace(lo, hi, num, dtype=torch.float64, device=device)[start : start + length].to(torch.float32)


def apply_affine(img: torch.Tensor, G: torch.Tensor, *, margin: int = 224) -> torch.Tensor:
    """Apply the per-image affine G (B, 3, 3) with the reference's
    antialiased warp chain.

    `margin` is the static pad M that stands in for the reference's
    per-batch dynamic `get_padding`: whenever that pad would have been <= M,
    this is the reference's math (same padded content, grid and crop); for
    more extreme transforms the sampler's coordinate reflection supplies
    multi-mirrored content instead of the reference's retry loop."""
    kernel_1d = _const("sym6", img)
    len_k = kernel_1d.shape[0]
    pad_k = (len_k + 1) // 2  # 6
    B, C, h_o, w_o = img.shape
    M = margin

    img_pad = _reflect101_pad(img, M + pad_k)
    mode = _warp_mode()
    if mode == "matmul_fir":
        # the warp folds the up2-FIR into its tap matrices: the 2x image is
        # never built, only its dimensions are needed for the coordinates
        H2 = 2 * img_pad.shape[2] - (len_k - 1)
        W2 = 2 * img_pad.shape[3] - (len_k - 1)
    else:
        # separable: outer(flip k, flip k) == flip2d(outer(k, k))
        img_2x = upfirdn2d_separable(img_pad, torch.flip(kernel_1d, (0,)), up=2)
        H2, W2 = img_2x.shape[2], img_2x.shape[3]  # 2 * (h_o + 2M + 2 pad_k) - (len_k - 1)

    w_p = w_o + 2 * M + 1
    h_p = h_o + 2 * M + 1
    # The final crop keeps rows [M, M + h_o) of the downsampled result, which
    # depend only on the sampled 2x rows [2M, 2M + 2h_o + len_k - 2): only
    # that window of the reference's grid is evaluated.
    Lh = 2 * h_o + len_k - 2
    Lw = 2 * w_o + len_k - 2
    gx = _grid(-2.0 * M / w_o - 1.0, 2.0 * (w_p - M) / w_o - 1.0, W2, 2 * M, Lw, img.device)
    gy = _grid(-2.0 * M / h_o - 1.0, 2.0 * (h_p - M) / h_o - 1.0, H2, 2 * M, Lh, img.device)
    grid_x, grid_y = gx[None, None, :], gy[None, :, None]

    gi = _inv3(G)[:, :, :, None, None]  # (B, 3, 3, 1, 1)
    # affine_grid: (x', y') = G^-1[:2, :] @ (x, y, 1)
    xp = gi[:, 0, 0] * grid_x + gi[:, 0, 1] * grid_y + gi[:, 0, 2]
    yp = gi[:, 1, 0] * grid_x + gi[:, 1, 1] * grid_y + gi[:, 1, 2]
    # renormalize into padded-image space (`non_leaking.py:349-353`)
    xp = xp * (w_o / w_p) + ((w_o + 2.0 * M) / w_p - 1.0)
    yp = yp * (h_o / h_p) + ((h_o + 2.0 * M) / h_p - 1.0)
    # 2x pixel coords, align_corners=False convention
    x_pix = (xp + 1.0) * W2 / 2.0 - 0.5
    y_pix = (yp + 1.0) * H2 / 2.0 - 0.5

    if mode == "matmul_fir":
        img_affine = warp_bilinear_matmul_fir(img_pad, x_pix, y_pix, np.flip(np.asarray(SYM6, np.float32)))
    elif mode == "matmul":
        img_affine = warp_bilinear_matmul(img_2x, x_pix, y_pix)
    else:
        img_affine = _bilinear_sample_reflect(img_2x, x_pix, y_pix)
    # down2 'valid' over the restricted window is the crop
    return upfirdn2d_separable(img_affine, kernel_1d, down=2)  # (B, C, h_o, w_o)


def apply_color(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Per-pixel 3x3 colour matmul plus offset (`non_leaking.py:374-382`)."""
    rgb = torch.einsum("bij,bjhw->bihw", mat[:, :3, :3], img)
    return rgb + mat[:, :3, 3][:, :, None, None]


def augment(
    img: torch.Tensor,
    p: torch.Tensor,
    *,
    margin: int = 224,
    gen: Optional[torch.Generator] = None,
    transform: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None),
):
    """The full ADA augment (`non_leaking.py:394-398`): affine, then colour.
    A matrix missing from `transform` is drawn from `gen` at probability p.
    Returns (img, (G, C))."""
    B = img.shape[0]
    G, C = transform
    if G is None:
        G = sample_affine(gen, p, B, img.shape[2], img.shape[3])
    if C is None:
        C = sample_color(gen, p, B)
    img = apply_color(apply_affine(img, G, margin=margin), C)
    return img, (G, C)
