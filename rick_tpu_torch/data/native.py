"""ctypes bindings for the threaded batch decoder (`csrc/rickdata.cpp`).
Port of `rick_tpu/data/native.py`, same names and semantics.

`NativeImageDataset` reads a record store (`data/store.py`) through mmap
and decodes a whole batch in one C call: a pool of host threads decodes the
PNG or JPEG blobs, resizes the shorter side, center-crops, flips and writes
[-1, 1] CHW float32 into a buffer allocated here.  ctypes releases the GIL
for the call, so the loader's producer thread decodes while the training
step runs.  `data_stream` and `device_data_stream` take its `decode_batch`.

The decoders are the port's own (`csrc/png_decode.h`, `csrc/inflate.h`,
`csrc/jpeg_parse.h` over `csrc/jpeg_core.h`): `decode_image`'s pixels, no
libpng, libjpeg or zlib.  A blob that is neither PNG nor JPEG fails, as it
does in `rick_tpu` (BMP, TIFF and WebP blobs go through `ImageDataset`).
The transform is `rick_tpu`'s native one, not `train_transform`: the resize
is a float bilinear with half-pixel centers, the longer side's new length
rounded half away from zero (`process_one` and `resize_bilinear` here are
its plain numpy version, held bitwise to it), and the normalization is
`px * float32(1 / 127.5) - 1`, which is one float32 ulp from
`train_transform`'s `px / 127.5 - 1` for some levels.  On a store already
at the size the pixel levels are `ImageDataset.get`'s.

The library is built with g++ at first use (`ops/_build.host_library`); a
failed build raises.  `native_available()` and `build_error()` say whether
it builds, without raising.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from rick_tpu_torch.ops import _build

SRC = _build.CSRC / "rickdata.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_NORM = np.float32(1.0) / np.float32(127.5)  # rickdata.cpp's inv


def _load() -> ctypes.CDLL:
    """The library, built and loaded once per process; a failed build raises
    (and is tried again at the next call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.host_library(SRC)
            lib.rd_open.restype = ctypes.c_void_p
            lib.rd_open.argtypes = [ctypes.c_char_p]
            lib.rd_close.restype = None
            lib.rd_close.argtypes = [ctypes.c_void_p]
            lib.rd_count.restype = ctypes.c_int64
            lib.rd_count.argtypes = [ctypes.c_void_p]
            lib.rd_decode_batch.restype = ctypes.c_int
            lib.rd_decode_batch.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int,
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int,
            ]
            lib.rd_why.restype = ctypes.c_int
            lib.rd_why.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.rd_inflate.restype = ctypes.c_int64
            lib.rd_inflate.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


_UNBUILT = object()
_built = _UNBUILT  # host_build's result, once asked: None, or why it failed


def native_available() -> bool:
    """Whether the library builds here, without raising; the build is tried
    once per process, and the reason it failed is kept for `build_error()`."""
    global _built
    with _lock:
        if _built is _UNBUILT:
            _built = _build.host_build(SRC)
        return _built is None


def build_error() -> Optional[str]:
    native_available()
    return _built


def inflate(data: bytes) -> bytes:
    """`zlib.decompress(data)` by the batch decoder's own inflate; corrupt
    or truncated data raises ValueError with zlib's reason."""
    lib = _load()
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    n = lib.rd_inflate(data, len(data), None, 0, err, len(err))
    if n < 0:
        raise ValueError(f"inflate: {err.value.decode()}")
    out = ctypes.create_string_buffer(max(n, 1))
    lib.rd_inflate(data, len(data), out, n, err, len(err))
    return out.raw[:n]


def resize_shape(h: int, w: int, size: int) -> tuple:
    """(new h, new w) with the shorter side at `size`, the other rounded half
    away from zero (`std::lround`) and at least 1."""
    def lround(x: float) -> int:
        n = int(x)
        return n + 1 if x - n >= 0.5 else n

    if h < w:
        return size, max(1, lround(w * size / h))
    return max(1, lround(h * size / w)), size


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """The plain version of rickdata.cpp's `resize_bilinear`, in float32
    numpy, operation for operation: HWC uint8 -> (nh, nw, C) uint8."""
    h, w = img.shape[:2]
    one, half = np.float32(1), np.float32(0.5)

    def taps(n_out: int, n_in: int):
        f = (np.arange(n_out, dtype=np.float32) + half) * (np.float32(n_in) / np.float32(n_out)) - half
        i0 = np.floor(f).astype(np.int64)
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), f - i0.astype(np.float32)

    y0, y1, wy = taps(nh, h)
    x0, x1, wx = taps(nw, w)
    a = img.astype(np.float32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = a[y0][:, x0] * (one - wx) + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * (one - wx) + a[y1][:, x1] * wx
    return (top * (one - wy) + bot * wy + half).astype(np.uint8)


def process_one(img: np.ndarray, size: int, flip: bool) -> np.ndarray:
    """The plain version of rickdata.cpp's `process_one` after the decode:
    HWC uint8 -> CHW float32 in [-1, 1]."""
    h, w = img.shape[:2]
    if min(h, w) != size:
        img = resize_bilinear(img, *resize_shape(h, w, size))
        h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    img = img[top : top + size, left : left + size]
    if flip:
        img = img[:, ::-1]
    return np.ascontiguousarray(img.transpose(2, 0, 1)).astype(np.float32) * _NORM - np.float32(1)


class NativeImageDataset:
    """RecordStore-backed dataset with C++ multithreaded batch decode.

    Produces `rick_tpu`'s native transform chain (resize shorter side
    bilinear, center crop, optional horizontal flip, [-1,1] CHW float32)."""

    def __init__(self, path: str, resolution: int = 256, *, flip: bool = True,
                 indices=None, n_threads: int = 0):
        self._lib = _load()
        self._handle = self._lib.rd_open(path.encode())
        if not self._handle:
            raise IOError(f"cannot open record store at {path}")
        self.resolution = resolution
        self.flip = flip
        total = self._lib.rd_count(self._handle)
        self.indices = np.asarray(
            indices if indices is not None else np.arange(total), np.int64
        )
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)

    def __len__(self):
        return len(self.indices)

    def decode_batch(self, batch_indices, rng: np.random.Generator) -> np.ndarray:
        """(n, 3, resolution, resolution) float32 of the dataset's items
        `batch_indices`; the flips are `rng.random(n) < 0.5`, drawn only when
        `flip` is set.  A record that does not decode raises IOError naming
        it and why."""
        idx = self.indices[np.asarray(batch_indices, np.int64)]
        n = len(idx)
        flips = (
            (rng.random(n) < 0.5).astype(np.uint8)
            if self.flip
            else np.zeros(n, np.uint8)
        )
        out = np.empty((n, 3, self.resolution, self.resolution), np.float32)
        rc = self._lib.rd_decode_batch(
            self._handle, np.ascontiguousarray(idx), n, self.resolution,
            flips, out.reshape(-1), self.n_threads,
        )
        if rc != 0:
            why = ctypes.create_string_buffer(512)
            self._lib.rd_why(self._handle, int(idx[rc - 1]), self.resolution, why, len(why))
            raise IOError(f"native decode failed at record {idx[rc - 1]}: {why.value.decode(errors='replace')}")
        return out

    # ImageDataset-compatible single-item access
    def get(self, i: int, rng: np.random.Generator) -> np.ndarray:
        return self.decode_batch([i], rng)[0]

    def close(self):
        if self._handle:
            self._lib.rd_close(self._handle)
            self._handle = None
