"""The bilinear warp as two-tap interpolation matrix products.  Port of
`rick_tpu/augment/warp.py`.

Bilinear interpolation factors through one-axis selections:

    out[p] = sum_r Lrow[p, r] * (sum_w F[r, w] * Lcol[p, w])

where Lrow holds the two row taps of output point p ((1 - wy) at y0, wy at
y0 + 1) and Lcol its two column taps.  The row stage is a matrix product
`Lrow @ F`, the column stage a multiply-reduce, and the backward, by
autograd, is the transposed product: no scatter.

The output grid is processed in TILE x TILE blocks.  An affine map sends a
tile into a bounded input footprint (at most (|a| + |b|) * TILE + 2 per
axis), which is read out of the image at a per-tile offset: one
`torch.gather` of flat indices.  The footprint is sized for combined scales
up to `scale_max` * sqrt 2; beyond that (the deep zoom-out tail) the taps
clamp to the footprint's edge, and the result parts from `gather`'s.

`warp_bilinear_matmul_fir` folds the sym6 up2-FIR into the tap matrices:
it reads the padded image directly and never builds the 2x image.

TILE is `RICK_ADA_WARP_TILE` (default 32), read on every call.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import numpy as np
import torch


def _reflect_coord(pix, size: int):
    """Fold a continuous pixel coordinate into [-0.5, size-0.5) by mirror
    reflection about the image edges (grid_sample 'reflection',
    align_corners=False convention)."""
    period = 2.0 * size
    t = torch.remainder(pix + 0.5, period)
    t = torch.where(t < 0, t + period, t)
    t = torch.where(t >= size, period - t - 1e-6, t)  # mirror upper half
    return t - 0.5


def _tap_matrix(coord, start, n_local: int, n_global: int):
    """(..., P) folded continuous coords -> (..., P, n_local) two-tap
    interpolation matrices relative to footprints starting at `start`
    (..., one per row of coords).

    The taps are the gather sampler's: t0 = floor(c) clipped to
    [0, n_global - 1], t1 = t0 + 1 clipped, weight w = c - floor(c) of the
    unclipped floor.  Both are made footprint-local; the final clip to
    [0, n_local - 1] fires only in beyond-footprint tails."""
    c0 = torch.floor(coord)
    w = coord - c0
    t0 = torch.clamp(c0.to(torch.int64), 0, n_global - 1)
    t1 = torch.clamp(t0 + 1, 0, n_global - 1)
    l0 = torch.clamp(t0 - start[..., None], 0, n_local - 1)
    l1 = torch.clamp(t1 - start[..., None], 0, n_local - 1)
    iota = torch.arange(n_local, device=coord.device)
    m0 = (iota == l0[..., None]).to(coord.dtype) * (1.0 - w)[..., None]
    m1 = (iota == l1[..., None]).to(coord.dtype) * w[..., None]
    return m0 + m1


def _default_tile() -> int:
    return int(os.environ.get("RICK_ADA_WARP_TILE", "32"))


def _tiles(a, T: int, nh: int, nw: int):
    """(B, Lh, Lw) -> (B, nh * nw, T * T), padding by edge replication."""
    B, Lh, Lw = a.shape
    rows = torch.clamp(torch.arange(nh * T, device=a.device), max=Lh - 1)
    cols = torch.clamp(torch.arange(nw * T, device=a.device), max=Lw - 1)
    a = a[:, rows][:, :, cols]
    return a.reshape(B, nh, T, nw, T).transpose(2, 3).reshape(B, nh * nw, T * T)


def _untile(out, T: int, nh: int, nw: int, Lh: int, Lw: int):
    """(B, nt, C, P) -> (B, C, Lh, Lw)."""
    B, _, C, _ = out.shape
    out = out.reshape(B, nh, nw, C, T, T).permute(0, 3, 1, 4, 2, 5)
    return out.reshape(B, C, nh * T, nw * T)[:, :, :Lh, :Lw]


def _footprints(img, r0, c0, FR: int, FC: int):
    """img (B, C, H, W), per-tile offsets r0, c0 (B, nt) -> the footprints
    img[b, :, r0 : r0 + FR, c0 : c0 + FC], (B, nt, C, FR, FC), as one gather
    of flat indices (its backward is a scatter-add into img)."""
    B, C, H, W = img.shape
    nt = r0.shape[1]
    rr = torch.arange(FR, device=img.device)
    cc = torch.arange(FC, device=img.device)
    idx = (r0[:, :, None, None] + rr[:, None]) * W + (c0[:, :, None, None] + cc)  # (B, nt, FR, FC)
    idx = idx.reshape(B, 1, nt * FR * FC).expand(B, C, -1)
    F = torch.gather(img.reshape(B, C, H * W), 2, idx)
    return F.reshape(B, C, nt, FR, FC).transpose(1, 2)


def _footprint_extent(T: int, scale_max: float) -> int:
    """A tile's footprint extent per axis: the affine tile extent bound plus
    floor/ceil slack."""
    return int(math.ceil(T * math.sqrt(2.0) * scale_max)) + 4


def warp_bilinear_matmul(img, x_pix, y_pix, *, tile: Optional[int] = None, scale_max: float = 2.0):
    """Bilinear-sample img (B, C, H, W) at continuous pixel coords x_pix,
    y_pix (B, Lh, Lw), reflecting out-of-range coordinates: the gather
    sampler's taps and weights, as tiled interpolation matrix products."""
    B, C, H, W = img.shape
    _, Lh, Lw = x_pix.shape
    T = tile if tile is not None else _default_tile()
    x = _reflect_coord(x_pix, W)
    y = _reflect_coord(y_pix, H)

    ext = _footprint_extent(T, scale_max)
    FR, FC = min(ext, H), min(ext, W)
    nh, nw = -(-Lh // T), -(-Lw // T)
    xt, yt = _tiles(x, T, nh, nw), _tiles(y, T, nh, nw)  # (B, nt, P)

    # per-tile footprint offsets, clamped so that the footprint stays inside
    ry = torch.clamp(torch.floor(yt.amin(-1)).to(torch.int64), 0, H - FR)
    cx = torch.clamp(torch.floor(xt.amin(-1)).to(torch.int64), 0, W - FC)
    F = _footprints(img, ry, cx, FR, FC)  # (B, nt, C, FR, FC)

    row_m = _tap_matrix(yt, ry, FR, H)  # (B, nt, P, FR)
    col_m = _tap_matrix(xt, cx, FC, W)  # (B, nt, P, FC)
    rsel = torch.einsum("btpr,btcrw->btcpw", row_m, F)  # row select and blend
    out = torch.einsum("btpw,btcpw->btcp", col_m, rsel)  # column taps
    return _untile(out, T, nh, nw, Lh, Lw)


@functools.lru_cache(maxsize=None)
def _up2_matrix(n_in: int, kernel_bytes: bytes) -> np.ndarray:
    """(n_out, n_in) band matrix of the 1-D up2-FIR (zero-insert by 2, true
    convolution with the K-tap kernel, 'valid'): U[r, j] = k[r + K - 1 - 2j]."""
    k = np.frombuffer(kernel_bytes, np.float32)
    K = k.shape[0]
    r = np.arange(2 * n_in - K + 1)[:, None]
    j = np.arange(n_in)[None, :]
    idx = r + K - 1 - 2 * j
    return np.where((idx >= 0) & (idx < K), k[np.clip(idx, 0, K - 1)], 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _up2_matrix_on(n_in: int, kernel_bytes: bytes, device: torch.device) -> torch.Tensor:
    """`_up2_matrix` on `device`, copied there once."""
    return torch.from_numpy(_up2_matrix(n_in, kernel_bytes)).to(device)


def _band_slices(U, r0, c0, FR: int, FC: int):
    """U (N, M), per-tile offsets r0, c0 (B, nt) -> U[r0 : r0 + FR,
    c0 : c0 + FC] per tile, (B, nt, FR, FC)."""
    rr = torch.arange(FR, device=U.device)
    cc = torch.arange(FC, device=U.device)
    return U[(r0[:, :, None] + rr)[..., None], (c0[:, :, None] + cc)[:, :, None, :]]


def warp_bilinear_matmul_fir(img_pad, x_pix, y_pix, k_up_1d, *, tile: Optional[int] = None,
                             scale_max: float = 2.0):
    """`warp_bilinear_matmul(up2_fir(img_pad), x, y)` with the FIR folded
    into the interpolation matrices (equal up to the order of the sums).

    The up2-FIR and the warp are linear per axis: the warp's two-tap
    matrices in 2x space compose with the FIR's band matrix U into
    matrices of about 2 + 12 taps over the padded image.  The 2x image is
    never built and each footprint is half as wide per axis.  x_pix, y_pix
    stay coordinates in the (virtual) 2x grid; `k_up_1d` is the up kernel
    as a numpy array (flipped sym6 for ADA)."""
    B, C, Hp, Wp = img_pad.shape
    _, Lh, Lw = x_pix.shape
    T = tile if tile is not None else _default_tile()
    k_np = np.asarray(k_up_1d, np.float32)
    K = k_np.shape[0]
    H2, W2 = 2 * Hp - (K - 1), 2 * Wp - (K - 1)
    U_r = _up2_matrix_on(Hp, k_np.tobytes(), img_pad.device)  # (H2, Hp)
    U_c = _up2_matrix_on(Wp, k_np.tobytes(), img_pad.device)  # (W2, Wp)

    x = _reflect_coord(x_pix, W2)
    y = _reflect_coord(y_pix, H2)

    # The 2x-space footprint and the padded-space one it maps to: 2x row r
    # draws padded rows [(r + 1) // 2, (r + 1) // 2 + K // 2 - 1], so rows
    # [r, r + FR) span at most FR // 2 + K // 2 + 1 padded rows.
    ext = _footprint_extent(T, scale_max)
    FR, FC = min(ext, H2), min(ext, W2)
    FRp, FCp = min(FR // 2 + K // 2 + 1, Hp), min(FC // 2 + K // 2 + 1, Wp)
    nh, nw = -(-Lh // T), -(-Lw // T)
    xt, yt = _tiles(x, T, nh, nw), _tiles(y, T, nh, nw)

    ry = torch.clamp(torch.floor(yt.amin(-1)).to(torch.int64), 0, H2 - FR)
    cx = torch.clamp(torch.floor(xt.amin(-1)).to(torch.int64), 0, W2 - FC)
    rp = torch.clamp(torch.div(ry + 1, 2, rounding_mode="floor"), 0, Hp - FRp)
    cp = torch.clamp(torch.div(cx + 1, 2, rounding_mode="floor"), 0, Wp - FCp)
    Fp = _footprints(img_pad, rp, cp, FRp, FCp)  # (B, nt, C, FRp, FCp)

    row2 = _tap_matrix(yt, ry, FR, H2)  # (B, nt, P, FR), 2x space
    col2 = _tap_matrix(xt, cx, FC, W2)  # (B, nt, P, FC)
    row_m = torch.einsum("btpr,btrj->btpj", row2, _band_slices(U_r, ry, rp, FR, FRp))  # (B, nt, P, FRp)
    col_m = torch.einsum("btpw,btwj->btpj", col2, _band_slices(U_c, cx, cp, FC, FCp))  # (B, nt, P, FCp)

    rsel = torch.einsum("btpr,btcrw->btcpw", row_m, Fp)
    out = torch.einsum("btpw,btcpw->btcp", col_m, rsel)
    return _untile(out, T, nh, nw, Lh, Lw)
