"""JPEG decoding without an image library.

`rick_tpu` opens JPEG inputs with PIL or cv2, which both run libjpeg-turbo
with its defaults; the machine with the card has neither, so the port keeps
its own decoder, which gives libjpeg-turbo's pixels bit for bit (the array of
`np.asarray(Image.open(f).convert("RGB"))`).

The markers are parsed here: SOI, APPn (JFIF, and Adobe's APP14 with its
transform flag; the rest skipped), COM, DQT, DHT, SOF0/SOF1/SOF2, DRI, SOS
and EOI.  The rest runs in `csrc/jpeg_decode.cpp`, one ctypes call per image,
built with g++ at first use (`ops/_build.host_library`): Huffman decoding
(sequential and progressive, with restart intervals), dequantization, the
slow integer IDCT, fancy upsampling and the YCbCr->RGB conversion.

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
import re
import struct
import threading

import numpy as np

from rick_tpu_torch.ops import _build

SOI = b"\xff\xd8"
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])
_SOF = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive", 0xC3: "lossless",
        0xC5: "differential sequential (hierarchical)", 0xC6: "differential progressive (hierarchical)",
        0xC7: "differential lossless (hierarchical)", 0xC9: "arithmetic-coded sequential",
        0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
        0xCD: "arithmetic-coded differential sequential", 0xCE: "arithmetic-coded differential progressive",
        0xCF: "arithmetic-coded differential lossless"}
_SAMPLING = {(1, 1), (2, 1), (2, 2)}  # (hmax / h, vmax / v) per component: 4:4:4, 4:2:2, 4:2:0
_SMOOTHED = 10  # libjpeg smooths progressive blocks while one of these first coefficients is incomplete
_MAX_BLOCKS_IN_MCU = 10
_SCAN_FIELDS = 20  # csrc/jpeg_decode.cpp's ScanField
_END_OF_SCAN = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")  # a marker other than RSTn after fill bytes

_lock = threading.Lock()
_decode = None  # the C entry point, once loaded


def _decode_fn():
    """The C entry point, built and loaded once per process."""
    global _decode
    with _lock:
        if _decode is None:
            fn = _build.host_library(_build.CSRC / "jpeg_decode.cpp").rick_jpeg_decode
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [ctypes.c_void_p] * 3 + [ctypes.c_int32, ctypes.c_void_p,
                                                                                      ctypes.c_int32, ctypes.c_void_p,
                                                                                      ctypes.c_char_p, ctypes.c_int32]
            fn.restype = ctypes.c_int
            _decode = fn
        return _decode


def _huffman_table(seg: bytes, pos: int, name: str):
    """One table of a DHT segment at `pos`: (class, id, counts, symbols, next pos)."""
    if pos + 17 > len(seg):
        raise ValueError(f"{name}: JPEG DHT segment ends inside a table header")
    tc, th = seg[pos] >> 4, seg[pos] & 15
    counts = seg[pos + 1 : pos + 17]
    n = sum(counts)
    if tc > 1 or th > 3:
        raise ValueError(f"{name}: JPEG DHT defines table class {tc} id {th}; classes are 0-1 and ids 0-3")
    if n > 256 or pos + 17 + n > len(seg):
        raise ValueError(f"{name}: JPEG DHT table class {tc} id {th} lists {n} symbols, more than its segment holds")
    symbols = seg[pos + 17 : pos + 17 + n]
    code, last = 0, max((i + 1 for i, c in enumerate(counts) if c), default=0)
    for length in range(1, last + 1):
        code += counts[length - 1]
        if code >= 1 << length:
            raise ValueError(f"{name}: JPEG Huffman table class {tc} id {th} has more codes of {length} bits "
                             "than fit (a corrupt DHT)")
        code <<= 1
    if tc == 0 and any(s > 15 for s in symbols):
        raise ValueError(f"{name}: JPEG DC Huffman table {th} holds a symbol above 15 (a corrupt DHT)")
    return tc, th, bytes(counts), bytes(symbols), pos + 17 + n


def _parse(blob: bytes, name: str):
    """The markers of `blob`: (frame record, quant (ncomp, 64), Huffman
    tables (n, 272), scan records (nscans, 20))."""
    def refuse(what):
        return ValueError(f"{name}: JPEG {what}")

    quant, huff, frame, restart = {}, {}, None, 0
    jfif, adobe = False, None
    scans, tables, table_index = [], [], {}
    latched, coef_bits, seen = {}, None, set()
    pos = 2
    while True:
        if pos >= len(blob):
            raise refuse("is truncated: the file ends before its EOI marker")
        if blob[pos] != 0xFF:
            raise refuse(f"has 0x{blob[pos]:02x} at byte {pos} where a marker should start (corrupt)")
        while pos < len(blob) and blob[pos] == 0xFF:
            pos += 1
        if pos >= len(blob):
            raise refuse("is truncated: the file ends before its EOI marker")
        marker = blob[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # RSTn or TEM outside a scan: no segment, skipped as libjpeg does
            continue
        if marker == 0xD8:
            raise refuse(f"has a second SOI marker at byte {pos - 2}")
        if pos + 2 > len(blob):
            raise refuse(f"is truncated inside marker 0x{marker:02x} at byte {pos - 2}")
        (length,) = struct.unpack_from(">H", blob, pos)
        if length < 2 or pos + length > len(blob):
            raise refuse(f"is truncated or corrupt: marker 0x{marker:02x} at byte {pos - 2} has length {length}, "
                         f"{len(blob) - pos} bytes remain")
        seg = blob[pos + 2 : pos + length]
        pos += length
        if 0xE0 <= marker <= 0xEF or marker == 0xFE:  # APPn, COM
            if marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
                jfif = True
            elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or p + 1 + size > len(seg):
                    raise refuse(f"DQT at byte {pos - length - 2} is corrupt (precision {pq}, table {tq})")
                vals = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, p + 1)
                q = np.zeros(64, np.uint16)
                q[NATURAL] = vals
                quant[tq] = q
                p += 1 + size
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th, counts, symbols, p = _huffman_table(seg, p, name)
                huff[tc, th] = (counts, symbols)
        elif marker == 0xDD:  # DRI
            if len(seg) != 2:
                raise refuse(f"DRI segment holds {len(seg)} bytes, not 2")
            (restart,) = struct.unpack(">H", seg)
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):  # SOFn
            if marker not in (0xC0, 0xC1, 0xC2):
                raise refuse(f"is {_SOF[marker]} (SOF{marker - 0xC0}): only Huffman-coded baseline, extended "
                             "sequential and progressive JPEG is decoded")
            if frame is not None:
                raise refuse("has a second SOF marker")
            frame = _frame(seg, marker == 0xC2, refuse)
            coef_bits = np.full((len(frame["ids"]), 64), -1, np.int64)
        elif marker == 0xCC:
            raise refuse("has a DAC marker (arithmetic coding is not decoded)")
        elif marker == 0xDA:  # SOS, then the entropy-coded data up to the next marker other than RSTn
            if frame is None:
                raise refuse("has an SOS marker before any SOF")
            rec = _scan(seg, frame, len(scans), quant, huff, latched, coef_bits, refuse)
            m = _END_OF_SCAN.search(blob, pos)
            if m is None:
                raise refuse(f"is truncated: scan {len(scans)} runs to the end of the file")
            for key in ("dc", "ac"):  # the tables as they stand at this scan
                for i, t in enumerate(rec[key]):
                    if t is not None:
                        if t not in table_index:
                            table_index[t] = len(tables)
                            tables.append(t)
                        rec[key][i] = table_index[t]
            seen.update(rec["comps"])
            scans.append(_scan_record(rec, restart, pos, m.start() - pos))
            pos = m.start()
        elif marker == 0xDC:
            raise refuse("has a DNL marker (a height given after the first scan is not decoded)")
        elif marker in (0xDE, 0xDF):
            raise refuse("is hierarchical (DHP/EXP marker)")
        else:
            raise refuse(f"has the unknown marker 0xff{marker:02x} at byte {pos - length - 2}")
    if frame is None or not scans:
        raise refuse("has no frame or no scan before its EOI")
    missing = [frame["ids"][c] for c in range(len(frame["ids"])) if c not in seen]
    if missing:
        raise refuse(f"never codes component(s) {missing} in a scan")
    if frame["progressive"]:
        incomplete = np.argwhere(coef_bits[:, :_SMOOTHED] != 0)
        if len(incomplete):
            c, k = incomplete[0]
            left = "never sent" if coef_bits[c, k] < 0 else f"its low {coef_bits[c, k]} bits never sent"
            raise refuse(f"is progressive and its scans leave coefficient {k} of component {frame['ids'][c]} "
                         f"incomplete ({left}): libjpeg smooths such blocks, which is not decoded")
    ncomp = len(frame["ids"])
    color = 0 if ncomp == 1 else _color_space(jfif, adobe, frame["ids"])
    rec = [frame["width"], frame["height"], ncomp, int(frame["progressive"]), color]
    for h, v in frame["sampling"]:
        rec += [h, v]
    huff_arr = np.zeros((max(len(tables), 1), 272), np.uint8)
    for i, (counts, symbols) in enumerate(tables):
        huff_arr[i, :16] = np.frombuffer(counts, np.uint8)
        huff_arr[i, 16 : 16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    return (np.array(rec, np.int32), np.stack([latched[c] for c in range(ncomp)]), huff_arr,
            np.array(scans, np.int32).reshape(-1, _SCAN_FIELDS))


def _frame(seg: bytes, progressive: bool, refuse) -> dict:
    if len(seg) < 6:
        raise refuse("SOF segment is shorter than its header")
    precision, height, width, n = struct.unpack_from(">BHHB", seg)
    if precision != 8:
        raise refuse(f"has {precision}-bit samples: only 8-bit JPEG is decoded")
    if n == 4:
        raise refuse("has 4 components (CMYK or YCCK): only gray and 3-component JPEG is decoded")
    if n not in (1, 3):
        raise refuse(f"has {n} components: only gray and 3-component JPEG is decoded")
    if len(seg) != 6 + 3 * n:
        raise refuse(f"SOF segment holds {len(seg)} bytes, {6 + 3 * n} for {n} components")
    if height == 0:
        raise refuse("has height 0 in its SOF (the height in a DNL marker is not decoded)")
    if width == 0:
        raise refuse("has width 0")
    ids, sampling, tq = [], [], []
    for i in range(n):
        cid, hv, t = seg[6 + 3 * i : 9 + 3 * i]
        ids.append(cid)
        sampling.append((hv >> 4, hv & 15))
        tq.append(t)
    if len(set(ids)) != n:
        raise refuse(f"has duplicate component ids {ids}")
    if any(not (1 <= h <= 4 and 1 <= v <= 4) for h, v in sampling) or any(t > 3 for t in tq):
        raise refuse(f"SOF is corrupt: sampling factors {sampling}, quantization tables {tq}")
    if n == 3:
        hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
        if any(hmax % h or vmax % v or (hmax // h, vmax // v) not in _SAMPLING for h, v in sampling):
            raise refuse(f"has sampling factors {sampling}: only 4:4:4, 4:2:2 and 4:2:0 are decoded")
    return dict(width=width, height=height, ids=ids, sampling=sampling, tq=tq, progressive=progressive)


def _scan(seg: bytes, frame: dict, index: int, quant, huff, latched, coef_bits, refuse) -> dict:
    """An SOS header checked against the frame and the tables defined so far;
    latches each component's quantization table at its first scan, as libjpeg
    does, and tracks the bits of each coefficient a progressive file has
    sent."""
    n = seg[0] if seg else 0
    if not 1 <= n <= 4 or len(seg) != 4 + 2 * n:
        raise refuse(f"SOS of scan {index} is corrupt ({n} components in {len(seg)} bytes)")
    comps, dc, ac = [], [], []
    for i in range(n):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in frame["ids"]:
            raise refuse(f"scan {index} names component {cid}, which the SOF does not define")
        c = frame["ids"].index(cid)
        if c in comps:
            raise refuse(f"scan {index} names component {cid} twice")
        comps.append(c)
        dc.append(tables >> 4)
        ac.append(tables & 15)
    ss, se, ah, al = seg[1 + 2 * n], seg[2 + 2 * n], seg[3 + 2 * n] >> 4, seg[3 + 2 * n] & 15
    if n > 1 and sum(frame["sampling"][c][0] * frame["sampling"][c][1] for c in comps) > _MAX_BLOCKS_IN_MCU:
        raise refuse(f"scan {index} has more than {_MAX_BLOCKS_IN_MCU} blocks per MCU")
    if not frame["progressive"]:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise refuse(f"sequential scan {index} has Ss={ss} Se={se} Ah={ah} Al={al}, not 0, 63, 0, 0")
        need_dc, need_ac = True, True
    else:
        dc_band = ss == 0
        if (dc_band and se != 0) or (not dc_band and (se < ss or se > 63 or n != 1)) or (ah and al != ah - 1) \
                or al > 13:
            raise refuse(f"progressive scan {index} has invalid parameters Ss={ss} Se={se} Ah={ah} Al={al} "
                         f"over {n} components")
        for c in comps:
            if not dc_band and coef_bits[c, 0] < 0:
                raise refuse(f"progressive scan {index} sends AC coefficients of component {frame['ids'][c]} "
                             "before its DC")
            expected = np.maximum(coef_bits[c, ss : se + 1], 0)
            if np.any(expected != ah):
                raise refuse(f"progressive scan {index} refines bits of component {frame['ids'][c]} that its "
                             f"earlier scans did not send in order (Ah={ah})")
            coef_bits[c, ss : se + 1] = al
        need_dc, need_ac = dc_band and ah == 0, not dc_band
    for i, c in enumerate(comps):
        if c not in latched:
            if frame["tq"][c] not in quant:
                raise refuse(f"component {frame['ids'][c]} uses quantization table {frame['tq'][c]}, which no DQT "
                             "defines before its first scan")
            latched[c] = quant[frame["tq"][c]]
        for cls, ids, needed in ((0, dc, need_dc), (1, ac, need_ac)):
            if needed and (cls, ids[i]) not in huff:
                raise refuse(f"scan {index} reads {'DC' if cls == 0 else 'AC'} Huffman table {ids[i]}, which no "
                             "DHT defines")
    return dict(comps=comps, dc=[huff[0, t] if need_dc else None for t in dc],
                ac=[huff[1, t] if need_ac else None for t in ac], band=(ss, se, ah, al))


def _scan_record(rec: dict, restart: int, offset: int, length: int) -> list:
    pad = [-1] * (4 - len(rec["comps"]))
    dc = [-1 if t is None else t for t in rec["dc"]]
    ac = [-1 if t is None else t for t in rec["ac"]]
    return [len(rec["comps"])] + rec["comps"] + pad + dc + pad + ac + pad + list(rec["band"]) + [restart, offset,
                                                                                                 length]


def _color_space(jfif: bool, adobe, ids) -> int:
    """libjpeg's guess for 3 components (jdapimin.c): 1 YCbCr, 2 RGB."""
    if jfif:
        return 1
    if adobe is not None:
        return 2 if adobe == 0 else 1
    return 2 if list(ids) == [82, 71, 66] else 1  # 'R', 'G', 'B'


def decode_jpeg(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, libjpeg-turbo's pixels as PIL gives
    them; what cannot be decoded raises ValueError naming it `name`."""
    blob = bytes(blob)
    if not blob.startswith(SOI):
        raise ValueError(f"cannot decode {name}: not a JPEG (starts with {blob[:4]!r})")
    frame, quant, huff, scans = _parse(blob, name)
    out = np.empty((int(frame[1]), int(frame[0]), 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _decode_fn()(blob, len(blob), frame.ctypes.data, quant.ctypes.data, huff.ctypes.data, len(huff),
                    scans.ctypes.data, len(scans), out.ctypes.data, err, len(err)):
        raise ValueError(f"{name}: JPEG {err.value.decode()}")
    return out
