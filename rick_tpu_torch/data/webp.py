"""WebP decoding without an image library.

`rick_tpu.data.prepare` opens a .webp input with PIL, which decodes through
libwebp's `WebPAnimDecoder` in non-premultiplied RGBA: the RGB of a pixel
does not depend on its alpha, and `convert("RGB")` drops the alpha.  The bar
is PIL's pixels, `np.asarray(Image.open(f).convert("RGB"))`, bit for bit;
the machine with the card has no PIL.

The RIFF container is parsed here: a simple file (`VP8 ` or `VP8L`), or an
extended one (`VP8X`) whose ALPH, ICCP, EXIF and XMP chunks are skipped (PIL
applies no ICC profile and no EXIF rotation on open), or an animation of
one frame, drawn at its offset on a transparent black canvas as
WebPAnimDecoder draws a first frame.  The bitstreams are decoded by
`csrc/webp_decode.cpp`, built with g++ at first use
(`ops/_build.host_library`): VP8L exactly, VP8 (lossy) as libwebp does, with
its fancy upsampling and its fixed-point YUV->RGB.

Anything else raises ValueError naming the file and what was found: an
animation of more than one frame, a VP8 frame that is not a key frame, a
frame whose size differs from the canvas, and a truncated or corrupt file.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from rick_tpu_torch.ops import _build

_lock = threading.Lock()
_fns = {}  # the C entry points, once loaded


def _c_fn(symbol: str):
    with _lock:
        if symbol not in _fns:
            fn = getattr(_build.host_library(_build.CSRC / "webp_decode.cpp"), symbol)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_char_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return _fns[symbol]


def is_webp(blob: bytes) -> bool:
    return len(blob) >= 12 and blob[:4] == b"RIFF" and blob[8:12] == b"WEBP"


def _chunks(blob: bytes, start: int, end: int, name: str):
    """(fourcc, payload) of the chunks in blob[start:end]."""
    pos = start
    while pos + 8 <= end:
        fourcc = blob[pos : pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        if pos + 8 + size > end:
            raise ValueError(f"cannot decode {name}: WebP chunk {fourcc!r} runs past the end of the file")
        yield fourcc, blob[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)


def _bitstream_size(fourcc: bytes, payload: bytes, name: str):
    """(width, height) from a VP8 or VP8L bitstream's header."""
    if fourcc == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F:
            raise ValueError(f"cannot decode {name}: WebP VP8L header missing")
        (bits,) = struct.unpack_from("<I", payload, 1)
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(payload) < 10:
        raise ValueError(f"cannot decode {name}: WebP VP8 header truncated")
    if payload[0] & 1:
        raise ValueError(f"cannot decode {name}: WebP VP8 frame is not a key frame")
    if payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"cannot decode {name}: WebP VP8 start code missing")
    w, h = struct.unpack_from("<HH", payload, 6)
    return w & 0x3FFF, h & 0x3FFF


def _decode_bitstream(fourcc: bytes, payload: bytes, name: str) -> np.ndarray:
    w, h = _bitstream_size(fourcc, payload, name)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    fn = _c_fn("rick_webp_vp8l" if fourcc == b"VP8L" else "rick_webp_vp8")
    if fn(payload, len(payload), w, h, out.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"cannot decode {name}: WebP {err.value.decode()}")
    return out


def _image_chunk(chunks, name: str):
    found = [(c, p) for c, p in chunks if c in (b"VP8 ", b"VP8L")]
    if len(found) != 1:
        raise ValueError(f"cannot decode {name}: WebP with {len(found)} image bitstreams")
    return found[0]


def decode_webp(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 RGB, PIL's pixels; what it cannot
    decode as PIL does raises ValueError naming `name`."""
    blob = bytes(blob)
    if not is_webp(blob):
        raise ValueError(f"cannot decode {name}: not a WebP (starts with {blob[:12]!r})")
    (riff_size,) = struct.unpack_from("<I", blob, 4)
    end = min(len(blob), 8 + riff_size)
    chunks = list(_chunks(blob, 12, end, name))
    if not chunks:
        raise ValueError(f"cannot decode {name}: WebP without chunks")
    first, payload = chunks[0]
    if first in (b"VP8 ", b"VP8L"):
        return _decode_bitstream(first, payload, name)
    if first != b"VP8X" or len(payload) < 10:
        raise ValueError(f"cannot decode {name}: WebP begins with chunk {first!r}")
    flags = payload[0]
    cw = int.from_bytes(payload[4:7], "little") + 1
    ch = int.from_bytes(payload[7:10], "little") + 1
    if flags & 0x02:  # animation
        frames = [p for c, p in chunks if c == b"ANMF"]
        if len(frames) != 1:
            raise ValueError(f"cannot decode {name}: WebP animation of {len(frames)} frames")
        fp = frames[0]
        if len(fp) < 16:
            raise ValueError(f"cannot decode {name}: WebP ANMF chunk truncated")
        x0 = 2 * int.from_bytes(fp[0:3], "little")
        y0 = 2 * int.from_bytes(fp[3:6], "little")
        fw = int.from_bytes(fp[6:9], "little") + 1
        fh = int.from_bytes(fp[9:12], "little") + 1
        img = _decode_bitstream(*_image_chunk(list(_chunks(fp, 16, len(fp), name)), name), name)
        if img.shape[:2] != (fh, fw) or x0 + fw > cw or y0 + fh > ch:
            raise ValueError(f"cannot decode {name}: WebP frame of {fw}x{fh} at ({x0}, {y0}) "
                             f"on a {cw}x{ch} canvas")
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[y0 : y0 + fh, x0 : x0 + fw] = img
        return canvas
    img = _decode_bitstream(*_image_chunk(chunks[1:], name), name)
    if img.shape[:2] != (ch, cw):
        raise ValueError(f"cannot decode {name}: WebP image of {img.shape[1]}x{img.shape[0]} "
                         f"on a {cw}x{ch} canvas")
    return img
