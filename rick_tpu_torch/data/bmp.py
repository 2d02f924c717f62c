"""BMP decoding without an image library.

`rick_tpu.data.prepare` opens a .bmp input with PIL, and BMP is lossless, so
the bar is PIL's pixels, `np.asarray(Image.open(f).convert("RGB"))`, bit for
bit; the machine with the card has no PIL.

Decoded, as Pillow's `BmpImagePlugin` reads them: the core (OS/2 1.x),
info, v2, v3, v4 and v5 headers; 1, 4 and 8-bit palettes (an index beyond
the palette reads black, as in Pillow), 16-bit 5-5-5 and the
5-6-5 / 5-5-5 bitfields, 24-bit, and 32-bit plain or with the bitfields
Pillow knows (alpha dropped); bottom-up and top-down rows; RLE8 and RLE4,
with Pillow's quirks (`csrc/lossless_decode.cpp`).  Anything else raises
ValueError naming the file: another depth, other bitfields, embedded JPEG or
PNG (compression 4, 5), the alpha bitfields (6), a palette of more than 256
entries, a gray palette that Pillow reads at another depth than the file's
(a black/white palette beyond 1 bit, a gray ramp at 1 or 4 bits), more
pixels than PIL opens (its decompression-bomb bound), and truncated data.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from rick_tpu_torch.ops import _build

SIGNATURE = b"BM"
MAX_PIXELS = 2 * 89_478_485  # PIL's Image.open raises DecompressionBombError beyond this (twice MAX_IMAGE_PIXELS)
_HEADERS = (12, 40, 52, 56, 64, 108, 124)  # core, info, v2, v3, OS/2 2.x, v4, v5
# bitfields Pillow reads: depth -> {(r, g, b, a) masks: byte order of the channels R, G, B in a pixel}
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),  # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),  # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),  # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),  # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),  # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),  # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),  # BGAR
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),  # BGRA
}
# 16 bits: (r, g, b) masks -> (shift, bits) of R, G and B
_MASKS16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 5, 6, 0, 5), (0x7C00, 0x3E0, 0x1F): (10, 5, 5, 5, 0, 5)}

_lock = threading.Lock()
_rle = None  # the C entry point, once loaded


def _rle_fn():
    global _rle
    with _lock:
        if _rle is None:
            fn = _build.host_library(_build.CSRC / "lossless_decode.cpp").rick_bmp_rle
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int]
            fn.restype = ctypes.c_int64
            _rle = fn
        return _rle


def is_bmp(blob: bytes) -> bool:
    """'BM' followed, at byte 14, by the size of a header Pillow reads."""
    return blob.startswith(SIGNATURE) and len(blob) >= 18 and struct.unpack_from("<I", blob, 14)[0] in _HEADERS


def _u(blob: bytes, fmt: str, pos: int, name: str):
    if pos + struct.calcsize(fmt) > len(blob):
        raise ValueError(f"cannot decode {name}: BMP truncated in its header")
    return struct.unpack_from("<" + fmt, blob, pos)


def _unpack_bits(rows: np.ndarray, width: int, bits: int) -> np.ndarray:
    """(h, stride) bytes -> (h, width) indices of `bits` (1, 4 or 8) bits, MSB first."""
    if bits == 8:
        return rows[:, :width]
    if bits == 4:
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(rows.shape[0], -1)[:, :width]
    return np.unpackbits(rows, axis=1)[:, :width]


def _expand(v: np.ndarray, shift: int, bits: int) -> np.ndarray:
    """A `bits`-bit field of 16-bit pixels scaled to 0-255 as Pillow does: v * 255 // max."""
    mx = (1 << bits) - 1
    return (((v.astype(np.int32) >> shift) & mx) * 255 // mx).astype(np.uint8)


def decode_bmp(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB, Pillow's pixels; what it cannot
    decode as Pillow does raises ValueError naming `name`."""
    blob = bytes(blob)
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"cannot decode {name}: not a BMP (starts with {blob[:8]!r})")
    (offset,) = _u(blob, "I", 10, name)
    (hsize,) = _u(blob, "I", 14, name)
    if hsize not in _HEADERS:
        raise ValueError(f"cannot decode {name}: BMP header of {hsize} bytes")
    if hsize == 12:
        width, height, _planes, bits = _u(blob, "HHHH", 18, name)
        compression, colors, direction, entry = 0, 0, -1, 3
    else:
        width, h_raw, _planes, bits, compression, _size, _xppm, _yppm, colors = _u(blob, "IIHHIIIII", 18, name)
        top_down = blob[18 + 7] == 0xFF  # Pillow's test of a negative height
        height = 2**32 - h_raw if top_down else h_raw
        direction, entry = (1 if top_down else -1), 4
        if width >= 2**31:
            raise ValueError(f"cannot decode {name}: BMP width {width}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"cannot decode {name}: BMP of {bits} bits per pixel")
    if compression not in (0, 1, 2, 3):
        kind = {4: "an embedded JPEG", 5: "an embedded PNG", 6: "alpha bitfields"}.get(compression, "")
        raise ValueError(f"cannot decode {name}: BMP compression {compression} {kind}".rstrip())
    if width == 0 or height == 0 or width * height > MAX_PIXELS:
        raise ValueError(f"cannot decode {name}: BMP of {width}x{height} pixels")

    fields = None
    if compression == 3:
        if hsize >= 52:
            r, g, b, a = _u(blob, "IIII", 54, name) if hsize >= 56 else _u(blob, "III", 54, name) + (0,)
        else:  # a 40-byte header: the three masks follow it
            r, g, b = _u(blob, "III", 14 + hsize, name)
            a = 0
        if bits == 32 and (r, g, b, a) in _MASKS32:
            fields = _MASKS32[(r, g, b, a)]
        elif bits == 24 and (r, g, b) == (0xFF0000, 0xFF00, 0xFF):
            fields = (2, 1, 0)
        elif bits == 16 and (r, g, b) in _MASKS16:
            fields = _MASKS16[(r, g, b)]
        else:
            raise ValueError(f"cannot decode {name}: BMP bitfields {(hex(r), hex(g), hex(b), hex(a))} at {bits} bits")
    elif compression in (1, 2) and bits != (8 if compression == 1 else 4):
        raise ValueError(f"cannot decode {name}: BMP RLE{8 if compression == 1 else 4} at {bits} bits per pixel")

    palette = None
    if bits <= 8:
        if colors > 256:
            raise ValueError(f"cannot decode {name}: BMP palette of {colors} entries")
        pos = 14 + hsize + (12 if compression == 3 and hsize == 40 else 0)
        raw = blob[pos : pos + entry * colors]
        if len(raw) < entry * colors:
            raise ValueError(f"cannot decode {name}: BMP truncated in its palette")
        bgr = np.frombuffer(raw, np.uint8).reshape(colors, entry)[:, 2::-1]
        gray_idx = [0, 255] if colors == 2 else list(range(colors))
        if all((bgr[i] == v).all() for i, v in enumerate(gray_idx)):
            # Pillow drops a gray palette and reads the samples as mode "1" (two
            # entries) or "L": the same pixels where that mode's depth is the file's
            mode = "1" if colors == 2 else "L"
            same = mode == "L" if compression in (1, 2) else (mode, bits) in (("1", 1), ("L", 8))
            if not same:
                raise ValueError(f"cannot decode {name}: {bits}-bit BMP whose {colors}-entry palette is gray, "
                                 f"which Pillow reads as mode {mode}")
        palette = np.zeros((256, 3), np.uint8)  # an index beyond the file's entries reads black, as in Pillow
        palette[:colors] = bgr

    if compression in (1, 2):
        dst = np.empty(width * height + width + 256, np.uint8)
        n = _rle_fn()(blob[offset:], len(blob) - offset, offset, dst.ctypes.data, width, height,
                      int(compression == 2))
        if n < width * height:
            raise ValueError(f"cannot decode {name}: BMP RLE data ends before the image does")
        idx = dst[: width * height].reshape(height, width)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        data = np.frombuffer(blob, np.uint8, count=max(0, min(len(blob) - offset, stride * height)), offset=offset)
        if data.size < stride * height:
            raise ValueError(f"cannot decode {name}: BMP pixel data truncated")
        rows = data.reshape(height, stride)
        if bits <= 8:
            idx = _unpack_bits(rows, width, bits)
        elif bits == 16:
            px = rows[:, : 2 * width].view("<u2")
            rs, rb, gs, gb, bs, bb = fields or _MASKS16[(0x7C00, 0x3E0, 0x1F)]
            img = np.stack([_expand(px, rs, rb), _expand(px, gs, gb), _expand(px, bs, bb)], axis=2)
        else:
            px = rows[:, : width * bits // 8].reshape(height, width, bits // 8)
            img = px[:, :, list(fields or (2, 1, 0))]
    if bits <= 8:
        img = palette[idx]
    if direction == -1:
        img = img[::-1]
    return np.ascontiguousarray(img)
