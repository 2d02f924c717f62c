"""PNG decode and encode without an image library.

The record stores hold PNG blobs (`prepare_data` writes them with PIL), and
`rick_tpu` decodes them with cv2 or PIL; the machine with the card has
neither, so the port keeps its own codec.

Decode covers every PNG: gray (1, 2, 4, 8, 16-bit), RGB, palette (1, 2,
4, 8-bit), gray+alpha and RGBA, plain or Adam7-interlaced.  The chunks are
parsed and checked (CRC), the IDAT stream is inflated with `zlib`, and the
row filters of each pass are undone by `csrc/png_unfilter.cpp`, built with
g++ at first use (`ops/_build.host_library`).  The result is HWC uint8 RGB,
as `rick_tpu.data.loader._decode` (cv2) returns it: gray is repeated over
the three channels, sub-byte gray scaled to 0-255, a palette looked up,
alpha (and tRNS) dropped, and a 16-bit sample keeps its high byte (PIL's
`convert("RGB")` clips 16-bit gray instead).  Any other blob
raises `ValueError` naming what it is (a JPEG goes through `data/jpeg.py`;
`data/image.py::decode_image` picks the decoder).

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
# color type -> samples per pixel, and the bit depths PNG allows it
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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
        return "a JPEG (decode_png reads PNG; decode_image reads both)"
    return f"not a PNG (starts with {bytes(blob[:8])!r})"


def _samples(rows: np.ndarray, width: int, depth: int, samples: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> (h, width, samples) uint8: 16-bit
    samples keep their high byte, sub-byte samples are unpacked (not yet
    scaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : width * samples].reshape(h, width, samples)
    if depth == 16:
        return rows[:, : 2 * width * samples].reshape(h, width, samples, 2)[..., 0]
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(h, width, depth)
    return (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)[..., None]


def decode_png(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB; what cannot be decoded raises
    ValueError naming it `name`."""
    blob = bytes(blob)
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"cannot decode {name}: {_describe(blob)}")
    header, idat, palette = None, [], None
    for ctype, data in _chunks(blob, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    width, height, depth, color, compression, filt, interlace = header
    if depth not in _DEPTHS.get(color, ()) or compression != 0 or filt != 0 or interlace > 1:
        raise ValueError(
            f"{name}: PNG of {depth}-bit {_COLOR_NAMES.get(color, f'color type {color}')} (compression "
            f"{compression}, filter {filt}, interlace {interlace}) is not a valid PNG"
        )
    if color == 3 and palette is None:
        raise ValueError(f"{name}: PNG palette image has no PLTE chunk")
    samples = _CHANNELS[color]
    bits = depth * samples
    raw = zlib.decompress(b"".join(idat))
    img = np.empty((height, width, samples), np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        if pos + ph * (stride + 1) > len(raw):
            raise ValueError(f"{name}: PNG image data holds {len(raw)} bytes, too few for {width}x{height} "
                             f"{depth}-bit {_COLOR_NAMES[color]}{' interlaced' if interlace else ''}")
        rows = np.empty((ph, stride), np.uint8)
        bad = _unfilter_fn()(raw[pos:], rows.ctypes.data, ph, stride, max(1, bits // 8))
        if bad:
            raise ValueError(f"{name}: PNG row {bad - 1} has filter type {raw[pos + (bad - 1) * (stride + 1)]}, "
                             "not 0-4")
        img[y0::dy, x0::dx] = _samples(rows, pw, depth, samples)
        pos += ph * (stride + 1)
    if pos != len(raw):
        raise ValueError(f"{name}: PNG image data holds {len(raw)} bytes, {width}x{height} {depth}-bit "
                         f"{_COLOR_NAMES[color]}{' interlaced' if interlace else ''} needs {pos}")
    if color == 3:
        if img.max(initial=0) >= len(palette):
            raise ValueError(f"{name}: PNG pixel indexes entry {img.max()} of a {len(palette)}-entry palette")
        return palette[img[..., 0]]
    if depth < 8:  # gray 1/2/4-bit to 0..255 (255, 85, 17 per level)
        img = img * np.uint8(255 // (2**depth - 1))
    if samples <= 2:  # gray, gray+alpha
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


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
