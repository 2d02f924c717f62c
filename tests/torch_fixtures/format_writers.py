"""Byte-by-byte writers of BMP, TIFF and WebP files, with numpy and the
standard library only, so they run where PIL is absent.

`make_format_fixtures.py` writes with them the variants PIL does not write
(the BMP core and v2-v5 headers, 4 and 16-bit BMP, bitfields, top-down rows,
RLE8 and RLE4; TIFF tiles, big-endian files, PackBits and LZW; a WebP
animation of one frame).  `chip_smoke.py` writes with `timing_files` the
512x512 BMP and TIFF files whose decode it times on the card's host, and
`tests/test_torch_image_formats.py` holds those variants to PIL's pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def bmp_bytes(width: int, height: int, bits: int, pixels: bytes, *, header: int = 40, compression: int = 0,
              palette=None, masks=None, top_down: bool = False, colors: int = 0) -> bytes:
    """A BMP file: `pixels` are the rows as stored (bottom-up unless top_down),
    `palette` (n, 3) RGB, `masks` the bitfields (after a 40-byte header, or in
    a larger one)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        pal = b"".join(bytes([b, g, r]) for r, g, b in (palette if palette is not None else []))
    else:
        h = (2**32 - height) if top_down else height
        info = struct.pack("<IIIHHIIIIII", header, width, h, 1, bits, compression, len(pixels), 2835, 2835,
                           colors, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<" + "I" * len(masks), *masks)
        if header == 40:
            info += extra
        else:
            body = extra.ljust(header - 40, b"\x00")
            if header >= 108:
                body = body[:16] + b"BGRs" + body[20:]  # LCS_WINDOWS_COLOR_SPACE
            info += body[: header - 40]
        pal = b"".join(bytes([b, g, r, 0]) for r, g, b in (palette if palette is not None else []))
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + pal + pixels


def packed_rows(idx: np.ndarray, bits: int, top_down: bool = False) -> bytes:
    """(h, w) indices -> rows of `bits` bits per pixel, each padded to 4 bytes."""
    h, w = idx.shape
    rows = idx if top_down else idx[::-1]
    if bits == 8:
        packed = rows.astype(np.uint8)
    else:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = rows
        g = padded.reshape(h, -1, per).astype(np.uint16)
        packed = sum(g[:, :, k] << (bits * (per - 1 - k)) for k in range(per)).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, : packed.shape[1]] = packed
    return out.tobytes()


def rgb_rows(img: np.ndarray, order, bytes_per_pixel: int, top_down: bool = False, filler: int = 0) -> bytes:
    """(h, w, 3) -> rows whose pixels hold R, G, B at byte positions `order`."""
    h, w, _ = img.shape
    px = np.full((h, w, bytes_per_pixel), filler, np.uint8)
    for c, pos in enumerate(order):
        px[:, :, pos] = img[:, :, c]
    rows = px if top_down else px[::-1]
    stride = ((w * bytes_per_pixel * 8 + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, : w * bytes_per_pixel] = rows.reshape(h, -1)
    return out.tobytes()


def rows16(img: np.ndarray, shifts, bits) -> bytes:
    h, w, _ = img.shape
    v = np.zeros((h, w), np.uint32)
    for c in range(3):
        v |= (img[:, :, c].astype(np.uint32) >> (8 - bits[c])) << shifts[c]
    stride = ((w * 16 + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, : 2 * w] = v[::-1].astype("<u2").view(np.uint8).reshape(h, -1)
    return out.tobytes()


def rle_bytes(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 of (h, w) indices, bottom-up: per row alternating encoded
    runs and absolute runs (word-aligned), an end of line, a delta of one
    pixel where the row's last value repeats the one before, and the end of
    bitmap.  RLE4's absolute runs are of an even count (Pillow reads
    count // 2 bytes)."""
    h, w = idx.shape
    out = bytearray()
    for y in range(h):
        row = [int(v) for v in idx[h - 1 - y]]
        x = 0
        while x < w:
            run = 1
            while x + run < w and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 3 or w - x < 4:
                n = min(run, w - x)
                out += bytes([n, (row[x] << 4) | row[x] if rle4 else row[x]])
                x += n
                continue
            n = min(w - x, 8)
            n -= n % 2 if rle4 else 0
            lit = row[x : x + n]
            if rle4:
                data = bytes((lit[k] << 4) | lit[k + 1] for k in range(0, n, 2))
            else:
                data = bytes(lit)
            out += bytes([0, n]) + data
            if len(data) % 2:
                out += b"\x00"
            x += n
        out += b"\x00\x00"  # end of line
    out += b"\x00\x01"
    return bytes(out)


def rle_with_delta(idx: np.ndarray) -> bytes:
    """RLE8 rows as `rle_bytes`, but the first row written as a run, then a
    delta command as Pillow reads it (two bytes it skips, then right and
    up), then the rest of that row as a run."""
    h, w = idx.shape
    rest = rle_bytes(idx[:-1], False)
    first = idx[-1]  # bottom row
    head = bytes([2, int(first[0])]) + b"\x00\x02" + b"\x00\x00" + bytes([3, 0])
    tail_n = w - 5
    head += bytes([tail_n, int(first[5])]) + b"\x00\x00"
    return head + rest


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early change), a clear code first and at a full table."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << width) and width < 12:  # the decoder, one entry behind, changes early
            width += 1
        if nxt >= 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([b])
    if w:
        put(table[w])
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_bytes(samples: np.ndarray, bits: int, photometric: int, *, compression: int = 1, predictor: int = 1,
               rows_per_strip: int | None = None, tile=None, order: str = "<", colormap=None, extras=()) -> bytes:
    """A one-image TIFF of (h, w, spp) samples at `bits` (1-8) per sample."""
    h, w, spp = samples.shape
    cw, ch = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // cw), -(-h // ch)
    chunks = []
    for r in range(down):
        for c in range(across):
            rows_here = ch if tile else min(ch, h - r * ch)
            block = np.zeros((rows_here, cw, spp), np.uint8)
            part = samples[r * ch : r * ch + rows_here, c * cw : (c + 1) * cw]
            block[: part.shape[0], : part.shape[1]] = part
            if predictor == 2:
                block = np.diff(block, axis=1, prepend=np.zeros((rows_here, 1, spp), np.uint8)).astype(np.uint8)
            if bits == 8:
                raw = block.tobytes()
            else:
                per = 8 // bits
                flat = block.reshape(rows_here, cw * spp)
                padded = np.zeros((rows_here, -(-flat.shape[1] // per) * per), np.uint16)
                padded[:, : flat.shape[1]] = flat
                g = padded.reshape(rows_here, -1, per)
                raw = sum(g[:, :, k] << (bits * (per - 1 - k)) for k in range(per)).astype(np.uint8).tobytes()
            chunks.append({1: lambda d: d, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
                           32773: packbits_encode}[compression](raw))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [1])]
    if tile:
        entries += [(322, 4, [cw]), (323, 4, [ch]), (324, 4, None), (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, None), (278, 4, [ch]), (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(colormap.T.reshape(-1))))
    if extras:
        entries.append((338, 3, list(extras)))
    entries.sort()
    fmt = {3: "H", 4: "I"}
    # layout: header, pixel chunks, out-of-line values, IFD
    pos = 8
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c) + (len(c) & 1)
    entries = [(t, ty, offsets if v is None else v) for t, ty, v in entries]
    ool = bytearray()
    ifd_entries = []
    for tag, ty, vals in entries:
        packed = struct.pack(order + fmt[ty] * len(vals), *vals)
        if len(packed) <= 4:
            field = packed.ljust(4, b"\x00")
        else:
            field = struct.pack(order + "I", pos + len(ool))
            ool += packed + (b"\x00" if len(packed) & 1 else b"")
        ifd_entries.append(struct.pack(order + "HHI", tag, ty, len(vals)) + field)
    ifd_pos = pos + len(ool)
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd_pos)
    body = b"".join(c + (b"\x00" if len(c) & 1 else b"") for c in chunks)
    ifd = struct.pack(order + "H", len(ifd_entries)) + b"".join(ifd_entries) + b"\x00\x00\x00\x00"
    return head + body + bytes(ool) + ifd


def riff(chunks) -> bytes:
    body = b"".join(c + struct.pack("<I", len(p)) + p + (b"\x00" if len(p) & 1 else b"") for c, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def one_frame_animation(simple: bytes, canvas, offset) -> bytes:
    """The bitstream of a simple WebP as the one frame of an animation, at
    `offset` (even) on a `canvas` (w, h)."""
    fourcc, size = simple[12:16], struct.unpack_from("<I", simple, 16)[0]
    frame = simple[12 : 20 + size + (size & 1)]
    w, h = struct.unpack_from("<HH", simple, 26) if fourcc == b"VP8 " else (None, None)
    if fourcc == b"VP8L":
        bits = struct.unpack_from("<I", simple, 21)[0]
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    w, h = w & 0x3FFF, h & 0x3FFF
    u24 = lambda v: struct.pack("<I", v)[:3]  # noqa: E731
    vp8x = bytes([0x02, 0, 0, 0]) + u24(canvas[0] - 1) + u24(canvas[1] - 1)
    anim = struct.pack("<IH", 0, 0)
    anmf = u24(offset[0] // 2) + u24(offset[1] // 2) + u24(w - 1) + u24(h - 1) + u24(100) + bytes([0x02]) + frame
    return riff([(b"VP8X", vp8x), (b"ANIM", anim), (b"ANMF", anmf)])


def palette_332() -> np.ndarray:
    """(256, 3) uint8: the 3-3-2 palette, index (r >> 5) << 5 | (g >> 5) << 2 | b >> 6."""
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7, (i & 3) * 255 // 3], axis=1).astype(np.uint8)


def timing_files(rgb: np.ndarray) -> dict:
    """{variant: (file bytes, the pixels it holds)} of one (h, w, 3) uint8
    image: 24-bit BMP; RLE8 BMP of its 3-3-2 quantization; TIFF in PIL's
    strips (65536 bytes each) uncompressed, PackBits, LZW, and Deflate with
    the horizontal predictor."""
    h, w, _ = rgb.shape
    idx = ((rgb[..., 0] >> 5) << 5) | ((rgb[..., 1] >> 5) << 2) | (rgb[..., 2] >> 6)
    rps = min(65536 // (3 * w), h)
    files = {"BMP 24-bit": (bmp_bytes(w, h, 24, rgb_rows(rgb, (2, 1, 0), 3)), rgb),
             "BMP RLE8": (bmp_bytes(w, h, 8, rle_bytes(idx, False), compression=1, palette=palette_332(), colors=256),
                          palette_332()[idx])}
    for label, comp, pred in (("none", 1, 1), ("PackBits", 32773, 1), ("LZW", 5, 1), ("Deflate+predictor", 8, 2)):
        files[f"TIFF {label}"] = (tiff_bytes(rgb, 8, 2, compression=comp, predictor=pred, rows_per_strip=rps), rgb)
    return files
