"""JPEG decoding without an image library.

`rick_tpu` opens JPEG inputs with PIL or cv2, which both run libjpeg-turbo
with its defaults; the machine with the card has neither, so the port keeps
its own decoder, which gives libjpeg-turbo's pixels bit for bit (the array of
`np.asarray(Image.open(f).convert("RGB"))`).

It runs in host C++, one ctypes call per image, built with g++ at first use
(`ops/_build.host_library`): `csrc/jpeg_parse.h` parses the markers (SOI,
APPn (JFIF, and Adobe's APP14 with its transform flag; the rest skipped),
COM, DQT, DHT, SOF0/SOF1/SOF2, DRI, SOS and EOI), and `csrc/jpeg_core.h`
does Huffman decoding (sequential and progressive, with restart intervals),
dequantization, the slow integer IDCT, fancy upsampling and the
YCbCr->RGB conversion.  The batch decoder (`data/native.py`) runs the same
two.

Decoded: 8-bit Huffman-coded baseline, extended sequential and progressive
JPEG with 1 component (gray, repeated over RGB) or 3 components at 4:4:4,
4:2:2 or 4:2:0, YCbCr or RGB as libjpeg decides (JFIF: YCbCr; else Adobe's
transform flag; else the component IDs).  No EXIF rotation and no ICC
transform, as in `rick_tpu`.  Anything else raises ValueError naming `name`
and what was found: arithmetic coding, lossless and hierarchical modes,
12-bit samples, 4 components (CMYK/YCCK), other sampling factors, a missing
table, a truncated or corrupt file, and a progressive file whose scans leave
any of a block's first 10 coefficients incomplete (libjpeg would smooth
those blocks).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from rick_tpu_torch.ops import _build

SOI = b"\xff\xd8"

_lock = threading.Lock()
_decode = None  # the C entry point, once loaded


def _decode_fn():
    """The C entry point, built and loaded once per process."""
    global _decode
    with _lock:
        if _decode is None:
            fn = _build.host_library(_build.CSRC / "jpeg_decode.cpp").rick_jpeg_decode
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_int32]
            fn.restype = ctypes.c_int
            _decode = fn
        return _decode


def decode_jpeg(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, libjpeg-turbo's pixels as PIL gives
    them; what cannot be decoded raises ValueError naming it `name`."""
    blob = bytes(blob)
    if not blob.startswith(SOI):
        raise ValueError(f"cannot decode {name}: not a JPEG (starts with {blob[:4]!r})")
    fn = _decode_fn()
    hw = np.zeros(2, np.int32)
    err = ctypes.create_string_buffer(512)
    if fn(blob, len(blob), hw.ctypes.data, None, err, len(err)) == 1:  # the markers alone, for the size
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
    if fn(blob, len(blob), hw.ctypes.data, out.ctypes.data, err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out
