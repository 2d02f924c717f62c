"""TIFF decoding without an image library.

`rick_tpu.data.prepare` opens a .tiff input with PIL, and what is decoded
here is lossless, so the bar is PIL's pixels, `np.asarray(Image.open(f)
.convert("RGB"))`, bit for bit; the machine with the card has no PIL.

The first image of the file (PIL's first frame) is read, in either byte
order, from strips or tiles in chunky layout (planar configuration 1):

* 1-bit bilevel and 8-bit gray (white-is-zero inverted), gray + alpha,
  1/2/4/8-bit palette (the 16-bit colour map divided by 256, as PIL does),
  RGB, RGB with an unassociated or unspecified alpha or an extra sample
  (dropped);
* no compression, PackBits and LZW (decoded by `csrc/lossless_decode.cpp`)
  and Deflate (tags 8 and 32946, by `zlib`), and the horizontal predictor
  (2) on 8-bit samples.

Anything else raises ValueError naming the file and what was found: BigTIFF,
JPEG (old and new), CCITT and the other compressions, 16-bit, signed and
float samples, CMYK, YCbCr, Lab and the other photometric interpretations,
associated (premultiplied) alpha, planar configuration 2, fill order 2, the
floating-point predictor, old-style LZW, a strip or tile of no rows or
columns, more pixels than PIL opens (its decompression-bomb bound), and
truncated or short data.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from rick_tpu_torch.ops import _build

_BIG = (b"II+\x00", b"MM\x00+")
SIGNATURES = (b"II*\x00", b"MM\x00*") + _BIG  # BigTIFF is recognised, and refused
_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d"}
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4", 5: "LZW", 6: "old-style JPEG",
                 7: "JPEG", 8: "Deflate", 32773: "PackBits", 32946: "Deflate", 34712: "JPEG 2000",
                 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_PHOTOMETRIC = {0: "white-is-zero", 1: "black-is-zero", 2: "RGB", 3: "palette", 4: "transparency mask",
                5: "CMYK", 6: "YCbCr", 8: "CIE Lab", 9: "ICC Lab", 10: "ITU Lab"}

MAX_PIXELS = 2 * 89_478_485  # PIL's Image.open raises DecompressionBombError beyond this (twice MAX_IMAGE_PIXELS)

_lock = threading.Lock()
_fns = {}  # the C entry points, once loaded


def _c_fn(symbol: str):
    with _lock:
        if symbol not in _fns:
            fn = getattr(_build.host_library(_build.CSRC / "lossless_decode.cpp"), symbol)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            fn.restype = ctypes.c_int64
            _fns[symbol] = fn
        return _fns[symbol]


def _ifd(blob: bytes, name: str):
    """{tag: tuple of values} of the first IFD."""
    bo = "<" if blob[:2] == b"II" else ">"
    if len(blob) < 8:
        raise ValueError(f"cannot decode {name}: TIFF truncated in its header")
    (pos,) = struct.unpack_from(bo + "I", blob, 4)
    if pos + 2 > len(blob):
        raise ValueError(f"cannot decode {name}: TIFF's first IFD lies beyond the file")
    (n,) = struct.unpack_from(bo + "H", blob, pos)
    if pos + 2 + 12 * n > len(blob):
        raise ValueError(f"cannot decode {name}: TIFF truncated in its first IFD")
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", blob, pos + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(bo + fmt) * count
        at = pos + 2 + 12 * i + 8
        if size > 4:
            (at,) = struct.unpack_from(bo + "I", blob, at)
        if at + size > len(blob):
            raise ValueError(f"cannot decode {name}: TIFF tag {tag} lies beyond the file")
        tags[tag] = struct.unpack_from(bo + fmt * count, blob, at) if typ != 2 else blob[at : at + count]
    return tags


def _one(tags, tag: int, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _decompress(chunk: bytes, compression: int, size: int, name: str) -> np.ndarray:
    """One strip or tile -> at least `size` bytes (the rest cut)."""
    if compression == 1:
        out = np.frombuffer(chunk, np.uint8)
    elif compression in (8, 32946):
        try:  # not a fallback: zlib's error on corrupt data becomes the decoder's ValueError
            out = np.frombuffer(zlib.decompressobj().decompress(chunk, size), np.uint8)
        except zlib.error as e:
            raise ValueError(f"cannot decode {name}: TIFF Deflate data is corrupt ({e})") from None
    else:
        symbol = {5: "rick_tiff_lzw", 32773: "rick_packbits"}[compression]
        out = np.empty(size, np.uint8)
        n = _c_fn(symbol)(chunk, len(chunk), out.ctypes.data, size)
        if n < 0:
            raise ValueError(f"cannot decode {name}: TIFF {_COMPRESSIONS[compression]} data is corrupt"
                             + (" or old-style" if compression == 5 else ""))
        out = out[:n]
    if out.size < size:
        raise ValueError(f"cannot decode {name}: TIFF {_COMPRESSIONS[compression]} chunk of {out.size} bytes "
                         f"where {size} are needed")
    return out[:size]


def _layout(tags, name: str):
    """(kind, photometric, bits, samples) of an image this decoder reads."""
    photometric = _one(tags, 262)
    bits = tags.get(258, (1,))
    spp = _one(tags, 277, 1)
    extras = tuple(tags.get(338, ()))
    if _one(tags, 339, 1) != 1 or any(f != 1 for f in tags.get(339, (1,))):
        raise ValueError(f"cannot decode {name}: TIFF sample format {tags[339]} (only unsigned integers)")
    if _one(tags, 284, 1) != 1:
        raise ValueError(f"cannot decode {name}: TIFF planar configuration {_one(tags, 284)}")
    if _one(tags, 266, 1) != 1:
        raise ValueError(f"cannot decode {name}: TIFF fill order {_one(tags, 266)}")
    if len(bits) != spp or len(set(bits)) != 1:
        raise ValueError(f"cannot decode {name}: TIFF bits per sample {bits} for {spp} samples")
    b = bits[0]
    found = f"{_PHOTOMETRIC.get(photometric, photometric)} TIFF, {spp} samples of {b} bits, extra samples {extras}"
    if photometric in (0, 1) and spp == 1 and b in (1, 8) and not extras:
        return "gray", photometric, b, spp
    if photometric == 1 and spp == 2 and b == 8 and extras == (2,):
        return "gray", photometric, b, spp
    if photometric == 2 and b == 8 and (spp, extras) in ((3, ()), (4, ()), (4, (0,)), (4, (2,))):
        return "rgb", photometric, b, spp
    if photometric == 3 and spp == 1 and b in (1, 2, 4, 8) and not extras:
        if 320 not in tags:
            raise ValueError(f"cannot decode {name}: palette TIFF without a colour map")
        return "palette", photometric, b, spp
    raise ValueError(f"cannot decode {name}: {found}")


def _samples(rows: np.ndarray, width: int, bits: int, spp: int) -> np.ndarray:
    """(h, rowbytes) -> (h, width, spp) uint8 samples (sub-byte ones unpacked, not scaled)."""
    h = rows.shape[0]
    if bits == 8:
        return rows[:, : width * spp].reshape(h, width, spp)
    unpacked = np.unpackbits(rows, axis=1)[:, : width * bits].reshape(h, width, bits)
    return (unpacked << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)[..., None]


def decode_tiff(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """TIFF bytes -> (H, W, 3) uint8 RGB, PIL's pixels; what it cannot
    decode as PIL does raises ValueError naming `name`."""
    blob = bytes(blob)
    if blob[:4] in _BIG:
        raise ValueError(f"cannot decode {name}: BigTIFF")
    if not blob.startswith(SIGNATURES):
        raise ValueError(f"cannot decode {name}: not a TIFF (starts with {blob[:8]!r})")
    tags = _ifd(blob, name)
    width, height = _one(tags, 256), _one(tags, 257)
    if not width or not height:
        raise ValueError(f"cannot decode {name}: TIFF without a width and a length")
    if width * height > MAX_PIXELS:
        raise ValueError(f"cannot decode {name}: TIFF of {width}x{height} pixels, beyond PIL's {MAX_PIXELS}")
    compression = _one(tags, 259, 1)
    if compression not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"cannot decode {name}: TIFF compression {compression} "
                         f"({_COMPRESSIONS.get(compression, 'unknown')})")
    kind, photometric, bits, spp = _layout(tags, name)
    predictor = _one(tags, 317, 1)
    if predictor not in (1, 2) or (predictor == 2 and bits != 8):
        raise ValueError(f"cannot decode {name}: TIFF predictor {predictor} at {bits} bits")

    if 322 in tags:  # tiles
        tw, tl = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
        cw, ch = tw, tl
    else:
        rps = min(_one(tags, 278, 2**32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
        cw, ch = width, rps
    if not cw or not ch or cw * ch > MAX_PIXELS:
        raise ValueError(f"cannot decode {name}: TIFF {'tile' if 322 in tags else 'strip'} of {cw}x{ch} pixels")
    if not offsets or not counts or len(offsets) != len(counts):
        raise ValueError(f"cannot decode {name}: TIFF without its chunk offsets and byte counts")
    across, down = -(-width // cw), -(-height // ch)
    if len(offsets) < across * down:
        raise ValueError(f"cannot decode {name}: TIFF has {len(offsets)} chunks where {across * down} are needed")
    rowbytes = -(-cw * spp * bits // 8)
    out = np.zeros((down * ch, across * cw, spp), np.uint8)
    for i in range(across * down):
        r, c = divmod(i, across)
        # a strip (not a tile) at the bottom holds only the rows left
        rows_here = ch if 322 in tags else min(ch, height - r * ch)
        o, n = offsets[i], counts[i]
        if o + n > len(blob):
            raise ValueError(f"cannot decode {name}: TIFF chunk {i} lies beyond the file")
        data = _decompress(blob[o : o + n], compression, rows_here * rowbytes, name).reshape(rows_here, rowbytes)
        if predictor == 2:
            px = data[:, : cw * spp].reshape(rows_here, cw, spp)
            data = np.cumsum(px, axis=1, dtype=np.uint8).reshape(rows_here, cw * spp)
        out[r * ch : r * ch + rows_here, c * cw : (c + 1) * cw] = _samples(data, cw, bits, spp)
    px = out[:height, :width]

    if kind == "gray":
        v = px[..., 0]
        if bits == 1:
            v = v * np.uint8(255)
        if photometric == 0:
            v = 255 - v
        return np.ascontiguousarray(np.repeat(v[..., None], 3, axis=2))
    if kind == "rgb":
        return np.ascontiguousarray(px[..., :3])
    cmap = np.asarray(tags[320], np.uint32)
    ncol = 1 << bits
    if cmap.size != 3 * ncol:
        raise ValueError(f"cannot decode {name}: TIFF colour map of {cmap.size} entries at {bits} bits")
    palette = (cmap.reshape(3, ncol).T // 256).astype(np.uint8)
    return np.ascontiguousarray(palette[px[..., 0]])
