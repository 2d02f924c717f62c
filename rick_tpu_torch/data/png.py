"""PNG decode and encode without an image library.

The record stores hold PNG blobs (`prepare_data` writes them with PIL), and
`rick_tpu` decodes them with cv2 or PIL; the machine with the card has
neither, so the port keeps its own codec.

Decode covers what the stores hold: 8-bit gray, RGB and RGBA, not
interlaced.  The chunks are parsed and checked (CRC), the IDAT stream is
inflated with `zlib`, and the row filters are undone by `csrc/png_unfilter.cpp`,
built with g++ at first use (`ops/_build.host_library`).  The result is
HWC uint8 RGB, as `rick_tpu.data.loader._decode` returns it: gray is
repeated over the three channels and alpha is dropped.  Any other blob, a
JPEG included, raises `ValueError` naming what it is.

Encode writes 8-bit RGB (or gray) with filter 0 on every row and zlib.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from rick_tpu_torch.ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for the 8-bit types decoded here
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}

_lock = threading.Lock()
_unfilter = None  # the C entry point, once loaded


def _unfilter_fn():
    """The C entry point, built and loaded once per process."""
    global _unfilter
    with _lock:
        if _unfilter is None:
            fn = _build.host_library(_build.CSRC / "png_unfilter.cpp").rick_png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            fn.restype = ctypes.c_int
            _unfilter = fn
        return _unfilter


def _chunks(blob: bytes, name: str):
    """(type, data) of each chunk after the signature, CRC checked."""
    pos = len(SIGNATURE)
    while pos < len(blob):
        if pos + 8 > len(blob):
            raise ValueError(f"{name}: PNG truncated in a chunk header at byte {pos}")
        (length,) = struct.unpack_from(">I", blob, pos)
        ctype = bytes(blob[pos + 4 : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(blob):
            raise ValueError(f"{name}: PNG truncated in chunk {ctype!r} at byte {pos}")
        data = bytes(blob[pos + 8 : end])
        (crc,) = struct.unpack_from(">I", blob, end)
        if zlib.crc32(ctype + data) != crc:
            raise ValueError(f"{name}: PNG chunk {ctype!r} at byte {pos} fails its CRC")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{name}: PNG has no IEND chunk")


def _describe(blob: bytes) -> str:
    if blob[:3] == b"\xff\xd8\xff":
        return "a JPEG (the record stores hold PNG; JPEG decoding is not ported)"
    return f"not a PNG (starts with {bytes(blob[:8])!r})"


def decode_png(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB; what cannot be decoded raises
    ValueError naming it `name`."""
    blob = bytes(blob)
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"cannot decode {name}: {_describe(blob)}")
    header, idat = None, []
    for ctype, data in _chunks(blob, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    width, height, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or compression != 0 or filt != 0 or interlace != 0:
        raise ValueError(
            f"{name}: PNG of {depth}-bit {_COLOR_NAMES.get(color, f'color type {color}')}"
            f"{', interlaced' if interlace else ''} (compression {compression}, filter {filt}): "
            "only 8-bit gray, RGB and RGBA, not interlaced, are decoded"
        )
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: PNG image data holds {len(raw)} bytes, {width}x{height} {_COLOR_NAMES[color]} "
                         f"needs {height * (stride + 1)}")
    out = np.empty((height, width, bpp), np.uint8)
    bad = _unfilter_fn()(raw, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"{name}: PNG row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}, not 0-4")
    if bpp == 1:
        return np.repeat(out, 3, axis=2)
    return np.ascontiguousarray(out[..., :3]) if bpp == 4 else out


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes: filter 0 on every row, zlib at
    `level`."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes (H, W, 3) or (H, W) uint8, not {img.shape} {img.dtype}")
    height, width = img.shape[:2]
    rows = img.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
