"""Offline dataset preparation: a folder of PNG, JPEG, BMP, TIFF and WebP
images -> a record store of PNG blobs.  Port of `rick_tpu/data/prepare.py`,
without PIL.

The images under `input_path` (recursive, sorted by path, as torchvision's
ImageFolder orders them) are decoded by `decode_image` to the pixels PIL
gives `rick_tpu` (JPEG as libjpeg-turbo, WebP as libwebp), the shorter
side is resized to `size`, the center is cropped, and the result is encoded
and written under key i in that order.  The resize is PIL's
(`Image.resize` with LANCZOS or BILINEAR, what `rick_tpu` calls), written
out in numpy so that the decoded pixels equal PIL's: two separable passes,
horizontal then vertical, each skipped where that side keeps its length;
per output pixel, the filter's support scaled by the downscale factor, the
taps normalised to sum 1 and rounded to 22-bit fixed point, an integer sum
rounded half up and clipped to uint8 between the passes.

A file that `decode_image` cannot decode as PIL does raises ValueError
naming it.
"""

from __future__ import annotations

import math
import multiprocessing
import os
from functools import partial
from typing import Callable, List, Tuple

import numpy as np

from rick_tpu_torch.data.image import decode_image
from rick_tpu_torch.data.png import encode_png
from rick_tpu_torch.data.store import RecordStoreWriter

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tiff"}  # rick_tpu's: the same files in the same order
PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images


def _bilinear(x: float) -> float:
    x = -x if x < 0 else x
    return 1.0 - x if x < 1.0 else 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_bilinear, 1.0)}


def resample_coeffs(in_size: int, out_size: int, filt: Callable[[float], float], support: float):
    """PIL's `precompute_coeffs` and `normalize_coeffs_8bpc` for a whole
    axis: (index (out, k) of the input taps, int64 weights (out, k), zero
    beyond each output's taps).  Scalar double arithmetic in PIL's order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    one = float(1 << PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:  # in order: not math.fsum, not sum() (compensated since Python 3.12)
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        index[xx, :xmax] = np.arange(xmin, xmin + xmax)
        weights[xx, :xmax] = [int(0.5 + w * one) if w >= 0 else int(-0.5 + w * one) for w in k]
    return index, weights


def _pass(img: np.ndarray, axis: int, out_size: int, filt, support) -> np.ndarray:
    """One separable pass along `axis` (0 rows, 1 columns) of (H, W, C) uint8."""
    index, weights = resample_coeffs(img.shape[axis], out_size, filt, support)
    taps = np.take(img.astype(np.int64), index, axis=axis)  # axis -> (out, k)
    w = weights.reshape((out_size, -1, 1, 1) if axis == 0 else (1, out_size, -1, 1))
    acc = (taps * w).sum(axis=axis + 1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, width: int, height: int, resample: str = "lanczos") -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C), as PIL's `Image.resize((width,
    height), LANCZOS or BILINEAR)` on an 8-bit image."""
    filt, support = FILTERS[resample]
    if img.shape[1] != width:
        img = _pass(img, 1, width, filt, support)
    if img.shape[0] != height:
        img = _pass(img, 0, height, filt, support)
    return img


def list_images(input_path: str) -> List[str]:
    """Every image file under input_path (recursive), sorted by path."""
    files = []
    for root, _dirs, names in os.walk(input_path):
        for name in names:
            if os.path.splitext(name)[1].lower() in _EXTS:
                files.append(os.path.join(root, name))
    return sorted(files)


def _resize_and_encode(item: Tuple[int, str], size: int, resample: str) -> Tuple[int, bytes]:
    i, path = item
    with open(path, "rb") as f:
        img = decode_image(f.read(), name=path)  # what it cannot decode raises, naming the file
    h, w = img.shape[:2]
    if min(w, h) != size:
        if w < h:
            nw, nh = size, max(1, round(h * size / w))
        else:
            nw, nh = max(1, round(w * size / h)), size
        img = pil_resize(img, nw, nh, resample)
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return i, encode_png(img[top : top + size, left : left + size])


def prepare_dataset(input_path: str, output_path: str, *, size: int = 256, n_worker: int = 8,
                    resample: str = "lanczos") -> int:
    """Write the store; returns the number of images.  `n_worker` > 1 runs
    a pool of that many processes (spawned)."""
    files = list_images(input_path)
    if not files:
        raise IOError(f"no images under {input_path}")
    items = list(enumerate(files))
    fn = partial(_resize_and_encode, size=size, resample=resample)
    with RecordStoreWriter(output_path) as writer:
        if n_worker <= 1:
            for item in items:
                writer.put(*fn(item))
        else:
            with multiprocessing.get_context("spawn").Pool(n_worker) as pool:
                for i, blob in pool.imap_unordered(fn, items):
                    writer.put(i, blob)
    return len(files)
