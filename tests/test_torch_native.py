"""The port's threaded batch decoder (`rick_tpu_torch/data/native.py`,
`csrc/rickdata.cpp`) against `rick_tpu`'s (`rick_tpu/data/native.py`, which
builds here over libpng and libjpeg) and against the port's Python path.

Held bitwise to `rick_tpu`'s `NativeImageDataset`: every PNG type and
interlace, the committed JPEG fixtures, resized, with flips, at 1 and 4
threads.  The pixel levels are `ImageDataset.get`'s (`decode_image`), the
floats one float32 ulp apart at most: both natives normalize as
`px * float32(1 / 127.5) - 1`, `train_transform` as `px / 127.5 - 1`.  The
inflate against `zlib.decompress`; the C++ JPEG marker parse refuses what
`decode_jpeg` refuses; failed records raise IOError naming the record; the
two packages' streams give the same batches; the train CLI opens a record
store through the batch decoder and streams a large set through
`decode_batch`; a header's edit changes the host build's directory."""

import ctypes
import io
import json
import math
import os
import struct
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from rick_tpu.data import data_stream as j_data_stream
from rick_tpu.data.loader import device_data_stream as j_device_data_stream
from rick_tpu.data.native import NativeImageDataset as JNativeImageDataset
from rick_tpu_torch.cli import train as train_cli
from rick_tpu_torch.data import (
    ImageDataset,
    NativeImageDataset,
    RecordStoreWriter,
    build_error,
    data_stream,
    decode_image,
    decode_jpeg,
    device_data_stream,
    encode_png,
    native_available,
)
from rick_tpu_torch.data import native
from rick_tpu_torch.ops import _build
from tests.lmdb_synth import write_synth_lmdb
from tests.test_torch_data import COLOR_TYPES, numpy_png_any, smooth_image
from tests.torch_fixtures import make_jpeg_fixtures as jpeg_fixtures
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

ULP = 2.0**-23  # a float32 ulp at 1: the most the two normalizations part by
PNG_KINDS = ["gray1", "gray2", "gray4", "gray8", "gray16", "palette1", "palette2", "palette4", "palette8",
             "gray+alpha8", "gray+alpha16", "RGB8", "RGB16", "RGBA8", "RGBA16"]


def write_store(path: Path, blobs) -> str:
    with RecordStoreWriter(str(path)) as w:
        for b in blobs:
            w.append(b)
    return str(path)


def levels(x: np.ndarray) -> np.ndarray:
    """[-1, 1] floats of either normalization -> the uint8 levels."""
    return np.rint((x.astype(np.float64) + 1.0) * 127.5).astype(np.uint8)


def python_path(path: str, size: int, n: int) -> np.ndarray:
    ds = ImageDataset(path, resolution=size, flip=False)
    return np.stack([ds.get(i, None) for i in range(n)])


def same_as_rick_tpu_and_python(path: str, size: int, n: int) -> np.ndarray:
    """Port native == rick_tpu native, bitwise; its levels == the Python
    path's, its floats within an ulp of them; returns the port's batch."""
    got = NativeImageDataset(path, size, flip=False).decode_batch(np.arange(n), None)
    want = JNativeImageDataset(path, size, flip=False).decode_batch(np.arange(n), None)
    assert got.shape == (n, 3, size, size) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    py = python_path(path, size, n)
    np.testing.assert_array_equal(levels(got), levels(py))
    np.testing.assert_array_equal(got, levels(py).astype(np.float32) * native._NORM - np.float32(1))
    assert np.abs(got - py).max() <= ULP
    return got


def png_of(kind: str, interlace: int, size) -> bytes:
    """The blob `tests/test_torch_data.py::test_every_png_type_decodes_as_rick_tpu`
    makes for the same case."""
    name = kind.rstrip("0123456789")
    depth = int(kind[len(name):])
    color, ch = COLOR_TYPES[name]
    rng = np.random.default_rng(depth * 31 + color + 7 * interlace + size[0])
    samples = rng.integers(0, 2**depth, (*size, ch))
    palette = rng.integers(0, 256, (2**depth, 3), dtype=np.uint8) if name == "palette" else None
    return numpy_png_any(samples, color, depth, interlace, palette)


def jpeg_blob(img: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **options)
    return buf.getvalue()


# ---- (a) every PNG type and the JPEG fixtures, at the stored size


@pytest.mark.parametrize("size", [(13, 11), (3, 2)])
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", PNG_KINDS)
def test_every_png_type_as_rick_tpu(tmp_path, kind, interlace, size):
    """Palette with tRNS, sub-byte gray, 16-bit (the high byte), alpha
    dropped, Adam7: the two natives bitwise, the levels `decode_png`'s."""
    blob = png_of(kind, interlace, size)
    got = same_as_rick_tpu_and_python(write_store(tmp_path / "s", [blob]), min(size), 1)
    h, w = size
    top, left = (h - min(size)) // 2, (w - min(size)) // 2
    crop = decode_image(blob)[top : top + min(size), left : left + min(size)]
    np.testing.assert_array_equal(levels(got[0]).transpose(1, 2, 0), crop)


@pytest.mark.parametrize("rel", sorted(json.loads((jpeg_fixtures.HERE / "manifest.json").read_text())["files"]))
def test_jpeg_fixtures_as_rick_tpu(tmp_path, rel):
    """Each committed JPEG (4:4:4, 4:2:2, 4:2:0, gray, progressive, restarts,
    odd sizes, the 512x512 cats) decoded by the C++ marker parse: bitwise
    `rick_tpu`'s libjpeg, the levels `decode_jpeg`'s."""
    blob = (jpeg_fixtures.HERE / rel).read_bytes()
    h, w = decode_jpeg(blob).shape[:2]
    same_as_rick_tpu_and_python(write_store(tmp_path / "s", [blob]), min(h, w), 1)


@pytest.mark.parametrize("seed", range(12))
def test_random_jpegs_as_decode_jpeg(tmp_path, seed):
    """Seeded sizes, sampling, modes, qualities and restart intervals, one
    store each: the two natives bitwise, the levels `decode_jpeg`'s."""
    rng = np.random.default_rng(seed)
    blobs = []
    for k in range(4):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        options = dict(subsampling=int(rng.integers(0, 3)), progressive=bool(rng.integers(0, 2)),
                       quality=int(rng.integers(5, 101)))
        if k == 3:
            options["restart_marker_blocks"] = 1
        img = smooth_image(rng, 24, 24, 3)
        blobs.append(jpeg_blob(np.asarray(Image.fromarray(img).resize((w, h))), **options))
    for k, blob in enumerate(blobs):
        h, w = decode_jpeg(blob).shape[:2]
        same_as_rick_tpu_and_python(write_store(tmp_path / str(k), [blob]), min(h, w), 1)


def _jpeg_refusals():
    """(name, blob, what decode_jpeg says) of files libjpeg-turbo's defaults
    read differently or not at all."""
    from tests.test_torch_jpeg import image, jpeg, patched, segments, without

    base = jpeg(image(13, 24, 32), subsampling=2, quality=90)
    prog = jpeg(image(13, 24, 32), progressive=True)
    scans = [p for p in range(len(prog) - 1) if prog[p : p + 2] == b"\xff\xda"]
    sos = next(p for p, m, n in segments(base) if m == 0xDA)
    start = sos + 2 + struct.unpack_from(">H", base, sos + 2)[0]
    buf = io.BytesIO()
    Image.fromarray(image(13, 24, 32)).convert("CMYK").save(buf, format="JPEG")
    return [
        ("arithmetic", base.replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic-coded sequential"),
        ("lossless", base.replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless"),
        ("cmyk", buf.getvalue(), "4 components"),
        ("12bit", patched(base, 0xC0, 0, 12), "12-bit"),
        ("sampling", patched(base, 0xC0, 7, 0x41), "sampling factors"),
        ("truncated_half", base[: len(base) // 2], "truncated"),
        ("truncated_eoi", base[: len(base) - 2], "truncated"),
        ("truncated_header", base[:200], "truncated"),
        ("bad_code", base[:start] + b"\xff\x00" * 40 + base[start + 80 :], "no DC Huffman code matches"),
        ("no_dht", without(base, 0xC4), "Huffman table 0, which no DHT"),
        ("no_dqt", without(base, 0xDB), "quantization table 0"),
        ("incomplete_progressive", prog[: scans[3]] + b"\xff\xd9", "progressive and its scans leave coefficient"),
    ]


@pytest.mark.parametrize("case", range(12), ids=[c[0] for c in _jpeg_refusals()])
def test_jpeg_refusals_are_decode_jpegs(tmp_path, case):
    """The batch decoder refuses what `decode_jpeg` refuses (both run
    `jpeg_parse.h`), with its words, and names the record."""
    _, blob, what = _jpeg_refusals()[case]
    with pytest.raises(ValueError, match=what):
        decode_jpeg(blob)
    ds = NativeImageDataset(write_store(tmp_path / "s", [encode_png(np.zeros((8, 8, 3), np.uint8)), blob]), 8,
                            flip=False)
    with pytest.raises(IOError, match=rf"record 1: JPEG .*{what}"):
        ds.decode_batch([0, 1], None)


# ---- (b) resized: rick_tpu's float bilinear, not F.interpolate


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("size", [32, 24, 64])
def test_resize_as_rick_tpu(tmp_path, size, fmt):
    """Stored (50+7i) x 44 (test_native_loader.py's shapes) down to 32 and 24
    and up to 64: bitwise `rick_tpu`'s native and the numpy transcription
    (`native.process_one`); within one level of the port's F.interpolate
    path."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (50 + 7 * i, 44, 3), dtype=np.uint8) for i in range(6)]
    blobs = [encode_png(im) if fmt == "png" else jpeg_blob(im, quality=90) for im in imgs]
    path = write_store(tmp_path / "s", blobs)
    got = NativeImageDataset(path, size, flip=False).decode_batch(np.arange(6), None)
    np.testing.assert_array_equal(got, JNativeImageDataset(path, size, flip=False).decode_batch(np.arange(6), None))
    plain = np.stack([native.process_one(decode_image(b), size, False) for b in blobs])
    np.testing.assert_array_equal(got, plain)
    assert np.abs(got - python_path(path, size, 6)).max() <= 1 / 127.5 + 1e-6


@pytest.mark.parametrize("shape, size, want", [
    ((17, 40), 4, (4, 9)), ((40, 17), 6, (14, 6)), ((9, 9), 4, (4, 4)), ((5, 200), 4, (4, 160)),
    ((8, 44), 3, (3, 17)), ((44, 8), 3, (17, 3)), ((2, 5), 1, (1, 3)), ((8, 36), 3, (3, 14)), ((4, 10), 2, (2, 5)),
])
def test_resize_shapes_round_as_lround(tmp_path, shape, size, want):
    """The new longer side is `std::lround`ed (half away from zero: 16.5 to
    17, 2.5 to 3), as in `rick_tpu`'s C++, where its Python `round` rounds
    half to even; the decode bitwise rick_tpu's and the numpy transcription."""
    assert native.resize_shape(*shape, size) == want
    img = smooth_image(np.random.default_rng(shape[0]), *shape, 3)
    path = write_store(tmp_path / "s", [encode_png(img)])
    got = NativeImageDataset(path, size, flip=False).decode_batch([0], None)
    np.testing.assert_array_equal(got, JNativeImageDataset(path, size, flip=False).decode_batch([0], None))
    np.testing.assert_array_equal(got[0], native.process_one(img, size, False))


def _color_space_blobs():
    """`tests/test_torch_jpeg.py::test_color_space_as_libjpeg_decides`'s
    files: JFIF, Adobe's transform flag and the component ids."""
    from tests.test_torch_jpeg import image, jpeg, segments, without

    base = jpeg(image(5, 13, 21), subsampling=2, quality=90)

    def ids(blob, new):
        sof = next(p for p, m, _ in segments(blob) if m == 0xC0)
        sos = next(p for p, m, _ in segments(blob) if m == 0xDA)
        out = bytearray(blob)
        for c, cid in enumerate(new):
            out[sof + 4 + 6 + 3 * c] = cid
            out[sos + 5 + 2 * c] = cid
        return bytes(out)

    def adobe(blob, transform):
        seg = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
        return blob[:2] + b"\xff\xee" + struct.pack(">H", 2 + len(seg)) + seg + blob[2:]

    no_jfif = without(base, 0xE0)
    return {"rgb_ids": ids(no_jfif, b"RGB"), "jfif_rgb_ids": ids(base, b"RGB"), "adobe0": adobe(no_jfif, 0),
            "jfif_adobe0": adobe(base, 0), "adobe1": adobe(no_jfif, 1), "other_ids": ids(no_jfif, [5, 9, 7])}


@pytest.mark.parametrize("case", ["rgb_ids", "jfif_rgb_ids", "adobe0", "jfif_adobe0", "adobe1", "other_ids"])
def test_jpeg_color_space_as_libjpeg(tmp_path, case):
    blob = _color_space_blobs()[case]
    h, w = decode_jpeg(blob).shape[:2]
    same_as_rick_tpu_and_python(write_store(tmp_path / "s", [blob]), min(h, w), 1)


# ---- (c) flips and threads


def test_flips_from_the_seed_as_rick_tpu(tmp_path):
    rng = np.random.default_rng(3)
    path = write_store(tmp_path / "s", [encode_png(smooth_image(rng, 20, 16, 3)) for _ in range(5)])
    port, jax = NativeImageDataset(path, 16, flip=True), JNativeImageDataset(path, 16, flip=True)
    r1, r2 = np.random.default_rng(42), np.random.default_rng(42)
    idx = [0, 0, 0, 0, 1, 2, 3, 4, 4, 2]
    for _ in range(3):
        np.testing.assert_array_equal(port.decode_batch(idx, r1), jax.decode_batch(idx, r2))
    assert r1.random() == r2.random()  # the same draws were taken
    unflipped = NativeImageDataset(path, 16, flip=False)
    r3 = np.random.default_rng(42)
    base = unflipped.decode_batch(idx, r3)
    assert r3.random() == np.random.default_rng(42).random()  # flip off draws nothing
    np.testing.assert_array_equal(port.decode_batch(idx, np.random.default_rng(42)),
                                  np.where((np.random.default_rng(42).random(len(idx)) < 0.5)[:, None, None, None],
                                           base[..., ::-1], base))


@pytest.mark.parametrize("threads", [2, 4, 16])
def test_threads_give_the_same_batch(tmp_path, threads):
    rng = np.random.default_rng(7)
    blobs = [encode_png(smooth_image(rng, 24, 30, 3)) for _ in range(6)]
    blobs += [jpeg_blob(smooth_image(rng, 30, 24, 3), subsampling=2) for _ in range(3)]
    path = write_store(tmp_path / "s", blobs)
    idx = np.random.default_rng(1).integers(0, 9, 40)
    one = NativeImageDataset(path, 20, n_threads=1).decode_batch(idx, np.random.default_rng(5))
    many = NativeImageDataset(path, 20, n_threads=threads).decode_batch(idx, np.random.default_rng(5))
    np.testing.assert_array_equal(one, many)


def test_indices_len_get_close_and_threads_default(tmp_path):
    """`indices` select records as `ImageDataset`'s do; `get` is one item of
    a batch; `n_threads` 0 is min(8, cpu count); the call goes through
    ctypes.CDLL (the GIL released), not PyDLL."""
    rng = np.random.default_rng(9)
    path = write_store(tmp_path / "s", [encode_png(smooth_image(rng, 16, 16, 3)) for _ in range(6)])
    ds = NativeImageDataset(path, 16, flip=False, indices=[5, 1, 3])
    assert len(ds) == 3 and ds.n_threads == min(8, os.cpu_count() or 1)
    py = ImageDataset(path, 16, flip=False, indices=[5, 1, 3])
    for i in range(3):
        np.testing.assert_array_equal(levels(ds.get(i, None)), levels(py.get(i, None)))
    assert type(native._load()) is ctypes.CDLL
    ds.close()
    ds.close()
    with pytest.raises(IOError, match="cannot open record store"):
        NativeImageDataset(str(tmp_path / "nothing"), 16)


def test_batches_from_several_python_threads_at_once(tmp_path):
    """The loader's producer thread and the main thread (`get_nsamples`)
    call one dataset at once: six threads, a failing batch among them, a
    short switch interval; each batch is what it is alone, the failing one
    names its record and why."""
    rng = np.random.default_rng(12)
    blobs = [encode_png(smooth_image(rng, 20, 24, 3)) for _ in range(8)] + [b"BM" + bytes(60)]
    ds = NativeImageDataset(write_store(tmp_path / "s", blobs), 16, n_threads=3)
    idx = np.random.default_rng(2).integers(0, 8, 64)
    alone = {k: ds.decode_batch(idx, np.random.default_rng(k)) for k in range(5)}
    got, errors = {}, []

    def run(k):
        if k == 5:
            with pytest.raises(IOError, match=r"record 8: not PNG or JPEG") as info:
                ds.decode_batch([0, 8, 1], np.random.default_rng(k))
            errors.append(info.value)
        else:
            got[k] = ds.decode_batch(idx, np.random.default_rng(k))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 1 and sorted(got) == list(range(5))
    for k in range(5):
        np.testing.assert_array_equal(got[k], alone[k])


# ---- (d) the inflate against zlib.decompress


def _payloads():
    rng = np.random.default_rng(11)
    return {
        "empty": b"",
        "one": b"x",
        "random": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
        "smooth": np.cumsum(rng.integers(-2, 3, 200000)).astype(np.uint8).tobytes(),
        "text": bytes(rng.choice(list(b"the quick brown fox\n"), 50000)),
        "zeros": bytes(300000),
    }


STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "fixed": zlib.Z_FIXED, "huffman": zlib.Z_HUFFMAN_ONLY,
              "rle": zlib.Z_RLE, "filtered": zlib.Z_FILTERED}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_inflate_equals_zlib(level, strategy):
    """Stored (level 0), fixed (Z_FIXED) and dynamic Huffman blocks, every
    window size, on incompressible, smooth, text-like and constant data."""
    for name, data in _payloads().items():
        for wbits in (9, 12, 15):
            c = zlib.compressobj(level, zlib.DEFLATED, wbits, 9, STRATEGIES[strategy])
            z = c.compress(data) + c.flush()
            assert native.inflate(z) == zlib.decompress(z) == data, (name, wbits)
    assert native.inflate(zlib.compress(b"abc", level) + b"trailing") == b"abc"  # as zlib.decompress


@pytest.mark.parametrize("what", ["adler", "truncated", "header", "block_type", "stored_lengths", "distance"])
def test_inflate_refuses_what_zlib_refuses(what):
    data = _payloads()["text"]
    z = bytearray(zlib.compress(data, 6))
    if what == "adler":
        z[-1] ^= 1
        match = "incorrect data check"
    elif what == "truncated":
        for cut in (1, len(z) // 2, len(z) - 1):
            with pytest.raises(zlib.error):
                zlib.decompress(bytes(z[:cut]))
            with pytest.raises(ValueError, match="truncated"):
                native.inflate(bytes(z[:cut]))
        return
    elif what == "header":
        z[1] ^= 1
        match = "incorrect header check"
    elif what == "block_type":
        z = bytearray(b"\x78\x9c\x07\x00")  # BFINAL 1, BTYPE 3
        match = "invalid block type"
    elif what == "stored_lengths":
        z = bytearray(zlib.compress(b"hello", 0))
        z[5] ^= 1  # NLEN no longer LEN's complement
        match = "invalid stored block lengths"
    else:  # a fixed block whose first symbol copies from distance 1 of an empty output
        bits = [1, 1, 0] + [0, 0, 0, 0, 0, 0, 1] + [0] * 5 + [0] * 7  # BFINAL, BTYPE 1; 257; distance 1; 256
        z = bytearray(b"\x78\x01" + np.packbits(np.array(bits + [0] * (-len(bits) % 8), np.uint8),
                                                  bitorder="little").tobytes())
        match = "too far back"
    with pytest.raises(zlib.error):
        zlib.decompress(bytes(z))
    with pytest.raises(ValueError, match=match):
        native.inflate(bytes(z))


@pytest.mark.parametrize("seed", range(4))
def test_inflate_on_corrupt_streams_agrees_with_zlib(seed):
    """Flipped bits, replaced bytes and cuts: the inflate refuses exactly
    what zlib refuses, and what both accept is the same bytes."""
    rng = np.random.default_rng(seed)
    payloads = list(_payloads().values())
    for trial in range(150):
        data = payloads[trial % len(payloads)][: int(rng.integers(0, 4000))]
        c = zlib.compressobj(int(rng.integers(0, 10)), zlib.DEFLATED, int(rng.integers(9, 16)), 9,
                             int(rng.choice(list(STRATEGIES.values()))))
        z = bytearray(c.compress(data) + c.flush())
        mode = trial % 3
        if mode == 0:
            k = int(rng.integers(0, len(z)))
            z[k] ^= 1 << int(rng.integers(0, 8))
        elif mode == 1:
            z = z[: int(rng.integers(0, len(z)))]
        else:
            for _ in range(3):
                z[int(rng.integers(0, len(z)))] = int(rng.integers(0, 256))
        z = bytes(z)
        assert outcome(native.inflate, z, ValueError) == outcome(zlib.decompress, z, zlib.error), trial


def outcome(fn, z: bytes, error):
    """fn(z), or None where it raises `error`."""
    try:
        return fn(z)
    except error:
        return None


# ---- (e) failed records


def png_of_size(w: int, h: int) -> bytes:
    """An 8-bit RGB PNG whose IHDR says w x h, its chunks' CRCs right, its
    IDAT an empty zlib stream."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"")) + chunk(b"IEND", b""))


def test_failed_records_raise_naming_them_as_rick_tpu(tmp_path):
    """A PNG whose IDAT fails its CRC, a PNG cut inside its IDAT, a BMP blob,
    and PNGs 0 wide, 0 tall and 2^31 wide (libpng refuses each): IOError
    naming the record in both packages, and here why."""
    good = encode_png(smooth_image(np.random.default_rng(1), 16, 16, 3))
    crc = bytearray(good)
    idat = bytes(crc).index(b"IDAT")
    crc[idat + 6] ^= 0x40  # inside IDAT's data
    bmp = io.BytesIO()
    Image.fromarray(smooth_image(np.random.default_rng(2), 16, 16, 3)).save(bmp, format="BMP")
    cases = {"CRC": bytes(crc), "truncated": good[: idat + 30], "not PNG or JPEG": bmp.getvalue(),
             "width 0": png_of_size(0, 16), "height 0": png_of_size(16, 0),
             "2147483648x1 is wider or taller": png_of_size(2**31, 1)}
    for why, blob in cases.items():
        path = write_store(tmp_path / why.replace(" ", "_"), [good, good, good, blob, good])
        for ds in (NativeImageDataset(path, 16, flip=False, n_threads=1),
                   NativeImageDataset(path, 16, flip=False, n_threads=4),
                   JNativeImageDataset(path, 16, flip=False)):
            with pytest.raises(IOError, match=r"native decode failed at record 3\b"):
                ds.decode_batch(np.arange(5), None)
        with pytest.raises(IOError, match=rf"record 3: .*{why}"):
            NativeImageDataset(path, 16, flip=False).decode_batch(np.arange(5), None)
        ok = NativeImageDataset(path, 16, flip=False).decode_batch([0, 4], None)  # the store stays usable
        np.testing.assert_array_equal(levels(ok), levels(python_path(path, 16, 2)))
    with pytest.raises(ValueError, match="CRC"):
        decode_image(cases["CRC"])


# ---- (f) the streams over the two packages' batch decoders


def test_data_stream_batches_are_rick_tpus(tmp_path):
    rng = np.random.default_rng(4)
    path = write_store(tmp_path / "s", [encode_png(smooth_image(rng, 18, 16, 3)) for _ in range(7)])
    got_s = data_stream(NativeImageDataset(path, 16), 2, seed=5, device="cpu")
    want_s = j_data_stream(JNativeImageDataset(path, 16), 2, seed=5)
    for _ in range(8):  # 3 batches an epoch (drop last): across epochs
        got, want = next(got_s), next(want_s)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    got_s.close()
    want_s.close()
    small_got = data_stream(NativeImageDataset(path, 16, indices=[1, 2]), 4, seed=3, device="cpu")
    small_want = j_data_stream(JNativeImageDataset(path, 16, indices=[1, 2]), 4, seed=3)
    for _ in range(3):  # a set smaller than the batch: draws with replacement
        np.testing.assert_array_equal(next(small_got).numpy(), next(small_want))
    small_got.close()
    small_want.close()


def test_device_data_stream_stages_rick_tpus_images(tmp_path):
    """Both streams stage the set through one `decode_batch` of every item,
    flips off; the staged images are equal."""
    rng = np.random.default_rng(6)
    path = write_store(tmp_path / "s", [encode_png(smooth_image(rng, 16, 20, 3)) for _ in range(5)])
    staged = {}

    def spy(ds, key):
        inner = ds.decode_batch

        def decode_batch(idx, rng):
            staged[key] = (list(idx), ds.flip, inner(idx, rng))
            return staged[key][2]
        ds.decode_batch = decode_batch
        return ds

    got_s = device_data_stream(spy(NativeImageDataset(path, 16), "port"), 2, seed=9, device="cpu")
    want_s = j_device_data_stream(spy(JNativeImageDataset(path, 16), "jax"), 2, seed=9)
    assert staged["port"][:2] == staged["jax"][:2] == (list(range(5)), False)
    np.testing.assert_array_equal(staged["port"][2], staged["jax"][2])
    batch = next(got_s).numpy()
    assert batch.shape == (2, 3, 16, 16) and all(
        any(np.array_equal(b, s) or np.array_equal(b, s[..., ::-1]) for s in staged["port"][2]) for b in batch)
    next(want_s)


# ---- (g) the train CLI's choice, a failed build, the host stream


def test_cli_opens_a_record_store_natively_and_lmdb_through_image_dataset(tmp_path):
    rng = np.random.default_rng(2)
    imgs = [smooth_image(rng, 16, 16, 3) for _ in range(3)]
    rdb = write_store(tmp_path / "rdb", [encode_png(im) for im in imgs])
    kv = {f"{i:06d}".encode(): encode_png(im) for i, im in enumerate(imgs)}
    kv[b"length"] = b"3"
    write_synth_lmdb(str(tmp_path / "lmdb"), kv, force_branch=True)
    got = train_cli.open_dataset(rdb, 16, indices=[2, 0], flip=False)
    assert isinstance(got, NativeImageDataset) and list(got.indices) == [2, 0]
    lm = train_cli.open_dataset(str(tmp_path / "lmdb"), 16, flip=False)
    assert type(lm) is ImageDataset and len(lm) == 3
    np.testing.assert_array_equal(levels(got.get(1, None)), levels(lm.get(0, None)))
    assert train_cli.open_dataset(rdb, 16).flip  # the CLI's training set flips


@pytest.mark.parametrize("where", ["g++", "host_library"])
def test_a_failed_build_raises_and_is_reported(tmp_path, monkeypatch, where):
    """g++ failing (`host_build` returns its output) or the loader raising:
    the CLI's `open_dataset` and `NativeImageDataset` raise, nothing falls
    back; `native_available` and `build_error` report it without raising,
    from one try of the build."""
    path = write_store(tmp_path / "s", [encode_png(np.zeros((8, 8, 3), np.uint8))])

    gxx_runs = []

    def no_gxx(src):
        gxx_runs.append(src)
        return f"g++ failed on {src.name} (1):\nno compiler here"

    def no_library(src):
        raise RuntimeError(no_gxx(src))

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_built", native._UNBUILT)
    if where == "g++":
        monkeypatch.setattr(_build, "host_build", no_gxx)
        assert not native_available()
        assert "no compiler here" in build_error()
        assert not native_available() and len(gxx_runs) == 1  # a failed build is not tried again when asked
    else:
        monkeypatch.setattr(_build, "host_library", no_library)
    with pytest.raises(RuntimeError, match="no compiler here"):
        train_cli.open_dataset(path, 8)
    with pytest.raises(RuntimeError, match="no compiler here"):
        NativeImageDataset(path, 8)
    monkeypatch.undo()
    assert native_available() and build_error() is None
    assert isinstance(train_cli.open_dataset(path, 8), NativeImageDataset)


def test_cli_streams_a_large_set_through_decode_batch(tmp_path, monkeypatch):
    """With the staging limit at 0, the few-shot set of 6 streams from the
    host thread: every batch comes from one `decode_batch` call; the run
    reaches its end with finite losses."""
    chip_smoke.write_synthetic_store(str(tmp_path), 16, 10, 6)
    calls = []
    inner = NativeImageDataset.decode_batch

    def counted(self, idx, rng):
        calls.append(len(idx))
        return inner(self, idx, rng)

    monkeypatch.setattr(NativeImageDataset, "decode_batch", counted)
    monkeypatch.setattr(train_cli, "STAGED_BYTES_MAX", 0)
    flags = chip_smoke.cli_flags(str(tmp_path)) + [
        "--size", "16", "--batch", "2", "--n_sample_train", "6", "--num_fisher_img", "2",
        "--allow_random_fisher_noise", "--warmup_iter", "2", "--fisher_freq", "100", "--iter", "0",
    ]
    summary = train_cli.main(flags, device="cpu")
    assert summary["iterations"] == 11
    assert len(calls) >= 11 and set(calls) == {2}, calls
    recs = [json.loads(line) for line in (tmp_path / "out" / "cli" / "stats.jsonl").read_text().splitlines()]
    assert recs and all(math.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))


# ---- the host build's cache key


def test_a_header_edit_changes_the_host_build(tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.cpp").write_text('#include "b.h"\n#include <vector>\nint a() { return B; }\n')
    (tmp_path / "b.h").write_text('#pragma once\n#include "sub/c.h"\n#define B 1\n')
    (tmp_path / "sub" / "c.h").write_text("// c\n")
    (tmp_path / "d.h").write_text("// not included\n")
    src = tmp_path / "a.cpp"
    assert _build.included(src) == sorted([tmp_path / "b.h", tmp_path / "sub" / "c.h"])
    first = _build.host_build_path(src)
    (tmp_path / "d.h").write_text("// edited\n")
    assert _build.host_build_path(src) == first
    (tmp_path / "sub" / "c.h").write_text("// c, edited\n")
    second = _build.host_build_path(src)
    assert second != first and second.name.startswith("host_a_")
    (tmp_path / "b.h").write_text('#pragma once\n#include "sub/c.h"\n#define B 2\n')
    assert _build.host_build_path(src) not in (first, second)
    names = {p.name for p in _build.included(_build.CSRC / "rickdata.cpp")}
    assert {"inflate.h", "png_decode.h", "png_unfilter.h", "jpeg_parse.h", "jpeg_core.h", "host_image.h"} <= names


def test_the_sources_include_no_library_header():
    """rickdata.cpp and what it includes: the C++ standard library, POSIX
    and this directory's headers; no libpng, libjpeg or zlib."""
    files = [_build.CSRC / "rickdata.cpp", *_build.included(_build.CSRC / "rickdata.cpp")]
    for f in files:
        for line in f.read_text().splitlines():
            if line.startswith("#include <"):
                header = line.split("<")[1].rstrip(">")
                assert header in {"algorithm", "atomic", "cmath", "cstdarg", "cstdint", "cstdio", "cstdlib",
                                  "cstring", "mutex", "string", "thread", "vector", "fcntl.h", "sys/mman.h",
                                  "sys/stat.h", "unistd.h"}, (f.name, header)
