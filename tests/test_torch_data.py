"""The port's data path against `rick_tpu`'s: the PNG codec (against
`rick_tpu`'s cv2/PIL decode, bitwise, and PIL; every color type and bit
depth, plain and interlaced), `ImageDataset` with the same numpy rng on PNG
and JPEG blobs, the lmdb store, the order of both streams, `get_nsamples`,
and `save_image_grid` without PIL."""

import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rick_tpu.data import ImageDataset as JImageDataset
from rick_tpu.data import data_stream as j_data_stream
from rick_tpu.data import get_nsamples as j_get_nsamples
from rick_tpu.data.loader import _decode as j_decode
from rick_tpu.data.loader import device_data_stream as j_device_data_stream
from rick_tpu.data.store import RecordStoreWriter as JRecordStoreWriter
from rick_tpu.utils.images import save_image_grid as j_save_image_grid
from rick_tpu_torch.data import (
    ImageDataset,
    RecordStoreWriter,
    data_stream,
    decode_image,
    decode_png,
    device_data_stream,
    encode_png,
    get_nsamples,
    open_image_store,
)
from tests.lmdb_synth import write_synth_lmdb
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def smooth_image(rng, h, w, channels):
    """Random pixels scaled up bilinearly: PNG filters have something to
    predict."""
    small = rng.integers(0, 256, (max(h // 4, 2), max(w // 4, 2), channels), dtype=np.uint8)
    img = Image.fromarray(small.squeeze(-1) if channels == 1 else small).resize((w, h), Image.BILINEAR)
    return np.asarray(img)


def _filter_row(ftype, row, prev, bpp):
    """PNG filter `ftype` of one row (uint8), as an encoder applies it."""
    x = row.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    b = prev.astype(np.int32)
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if ftype in (0, 7):  # 7: no such filter, for the refusal test
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) % 256).astype(np.uint8)


def numpy_png(img, ftypes):
    """A PNG of an HxWxC uint8 image (C 1, 3 or 4) whose row y uses filter
    ftypes[y % len(ftypes)]: an encoder independent of the port's."""
    h, w, ch = img.shape
    bpp = ch
    rows = img.reshape(h, w * ch)
    raw = bytearray()
    prev = np.zeros(w * ch, np.uint8)
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        raw += bytes([ft]) + _filter_row(ft, rows[y], prev, bpp).tobytes()
        prev = rows[y]

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    color = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


MODES = {"RGB": 3, "RGBA": 4, "gray": 1}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
COLOR_TYPES = {"gray": (0, 1), "RGB": (2, 3), "palette": (3, 1), "gray+alpha": (4, 2), "RGBA": (6, 4)}


def numpy_png_any(samples, color, depth, interlace, palette=None, ftypes=(0, 1, 2, 3, 4)):
    """A PNG of (H, W, C) samples (< 2**depth) of any color type and bit
    depth, Adam7-interlaced or not, rows filtered in turn by `ftypes`; a
    palette image gets its PLTE and a tRNS chunk: an encoder independent of
    the port's."""
    h, w, ch = samples.shape
    bits = depth * ch
    raw, n = bytearray(), 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(np.uint8)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(sub.shape[0], -1)
        else:
            unpacked = (sub.reshape(sub.shape[0], -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(unpacked.reshape(sub.shape[0], -1).astype(np.uint8), axis=1)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            ft = ftypes[n % len(ftypes)]
            raw += bytes([ft]) + _filter_row(ft, row, prev, max(1, bits // 8)).tobytes()
            prev, n = row, n + 1

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    extra = b""
    if palette is not None:
        extra = chunk(b"PLTE", palette.tobytes()) + chunk(b"tRNS", bytes(range(0, 256, 37)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + extra + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("size", [(13, 11), (3, 2)])
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", ["gray1", "gray2", "gray4", "gray16", "palette1", "palette2", "palette4", "palette8",
                                  "gray+alpha8", "gray+alpha16", "RGB16", "RGBA16", "RGB8"])
def test_every_png_type_decodes_as_rick_tpu(kind, interlace, size):
    """Palette, sub-byte gray, 16-bit (the high byte, as cv2 keeps it),
    gray+alpha, Adam7: bitwise `rick_tpu`'s decode."""
    name = kind.rstrip("0123456789")
    depth = int(kind[len(name):])
    color, ch = COLOR_TYPES[name]
    rng = np.random.default_rng(depth * 31 + color + 7 * interlace + size[0])
    samples = rng.integers(0, 2**depth, (*size, ch))
    palette = rng.integers(0, 256, (2**depth, 3), dtype=np.uint8) if name == "palette" else None
    blob = numpy_png_any(samples, color, depth, interlace, palette)
    got = decode_png(blob)
    assert got.shape == (*size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_decode(blob))
    np.testing.assert_array_equal(decode_image(blob), got)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_equals_rick_tpu_for_each_filter(mode, ftype):
    img = smooth_image(np.random.default_rng(ftype), 23, 37, MODES[mode]).reshape(23, 37, MODES[mode])
    blob = numpy_png(img, [ftype])
    got = decode_png(blob)
    np.testing.assert_array_equal(got, j_decode(blob))
    want = img[..., :3] if MODES[mode] >= 3 else np.repeat(img, 3, axis=2)
    np.testing.assert_array_equal(got, want)


def test_decode_equals_rick_tpu_with_mixed_filters():
    img = smooth_image(np.random.default_rng(5), 40, 33, 3)
    blob = numpy_png(img, [4, 0, 3, 1, 2, 4, 4, 3])
    np.testing.assert_array_equal(decode_png(blob), j_decode(blob))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("options", [{}, {"optimize": True}, {"compress_level": 1}])
def test_decode_equals_rick_tpu_on_pil_pngs(mode, options):
    ch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    img = smooth_image(np.random.default_rng(7), 64, 48, ch)
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG", **options)
    got = decode_png(buf.getvalue())
    assert got.shape == (64, 48, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_decode(buf.getvalue()))


@pytest.mark.parametrize("shape", [(17, 29, 3), (16, 16), (1, 5, 3)])
def test_encode_reads_back_through_pil(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    blob = encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), img)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(decode_png(blob), want)


def test_decode_refuses_what_it_does_not_decode():
    """decode_png names a JPEG (decode_image reads it) and refuses invalid
    PNGs; a palette PNG, refused before the port read every PNG, decodes as
    rick_tpu's."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(smooth_image(np.random.default_rng(4), 8, 8, 3)).convert("P").save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), j_decode(buf.getvalue()))
    palette = np.zeros((4, 3), np.uint8)
    with pytest.raises(ValueError, match="entry 7 of a 4-entry palette"):
        decode_png(numpy_png_any(np.full((2, 3, 1), 7), 3, 8, 0, palette))
    with pytest.raises(ValueError, match="16-bit palette .*not a valid PNG"):
        decode_png(numpy_png_any(np.zeros((2, 3, 1), np.int64), 3, 16, 0, palette))
    blob = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    blob[20] ^= 1  # inside IHDR: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(blob))
    with pytest.raises(ValueError, match="filter type 7"):
        decode_png(numpy_png(np.zeros((2, 4, 3), np.uint8), [0, 7]))


def write_stores(path, imgs, blobs=None):
    """The same PNG blobs (or `blobs`) through both packages' writers (they
    write the same bytes)."""
    blobs = blobs or [encode_png(im) for im in imgs]
    with RecordStoreWriter(str(path / "port")) as w:
        for b in blobs:
            w.append(b)
    with JRecordStoreWriter(str(path / "jax")) as w:
        for b in blobs:
            w.append(b)
    assert (path / "port" / "records.rdb").read_bytes() == (path / "jax" / "records.rdb").read_bytes()
    return str(path / "port"), str(path / "jax")


@pytest.mark.parametrize("stored", [(16, 16), (20, 24), (26, 19)])
def test_image_dataset_get_matches_rick_tpu(tmp_path, stored):
    """Bitwise at the stored size; within one level of 255 (1/127.5) where
    the shorter side is resized (F.interpolate vs cv2's fixed point)."""
    rng = np.random.default_rng(0)
    port, jax_path = write_stores(tmp_path, [smooth_image(rng, *stored, 3) for _ in range(6)])
    ds, jds = ImageDataset(port, resolution=16), JImageDataset(jax_path, resolution=16)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(6):
        got, want = ds.get(i, r1), jds.get(i, r2)
        assert got.shape == want.shape == (3, 16, 16) and got.dtype == np.float32
        if stored == (16, 16):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1 / 127.5 + 1e-6)


@pytest.mark.parametrize("stored", [(16, 16), (20, 24)])
def test_image_dataset_on_jpeg_blobs_matches_rick_tpu(tmp_path, stored):
    """A store of JPEG blobs (4:4:4, 4:2:0, progressive, gray): bitwise at
    the stored size, within one level of 255 where the shorter side is
    resized, as for PNG."""
    rng = np.random.default_rng(8)
    blobs = []
    for k, options in enumerate([{"subsampling": 0}, {"subsampling": 2}, {"progressive": True}, {"quality": 60}]):
        im = Image.fromarray(smooth_image(rng, *stored, 3))
        buf = io.BytesIO()
        (im.convert("L") if k == 3 else im).save(buf, format="JPEG", **options)
        blobs.append(buf.getvalue())
    port, jax_path = write_stores(tmp_path, None, blobs)
    ds, jds = ImageDataset(port, resolution=16), JImageDataset(jax_path, resolution=16)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(len(blobs)):
        got, want = ds.get(i, r1), jds.get(i, r2)
        assert got.shape == want.shape == (3, 16, 16)
        if stored == (16, 16):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1 / 127.5 + 1e-6)


def test_lmdb_store_reads_the_same_in_both_packages(tmp_path):
    rng = np.random.default_rng(2)
    imgs = [smooth_image(rng, 16, 16, 3) for _ in range(5)]
    kv = {f"{i:06d}".encode(): encode_png(im) for i, im in enumerate(imgs)}
    kv[b"length"] = b"5"
    write_synth_lmdb(str(tmp_path), kv, force_branch=True)
    store = open_image_store(str(tmp_path))
    assert len(store) == 5
    ds, jds = ImageDataset(str(tmp_path), resolution=16, flip=False), JImageDataset(str(tmp_path), 16, flip=False)
    for i in range(5):
        np.testing.assert_array_equal(decode_png(store.get(i)), imgs[i])
        np.testing.assert_array_equal(ds.get(i, None), jds.get(i, None))


def test_data_stream_order_matches_rick_tpu(tmp_path):
    rng = np.random.default_rng(4)
    port, jax_path = write_stores(tmp_path, [smooth_image(rng, 16, 16, 3) for _ in range(7)])
    got_s = data_stream(ImageDataset(port, 16), 2, seed=5, device="cpu")
    want_s = j_data_stream(JImageDataset(jax_path, 16), 2, seed=5)
    for _ in range(8):  # 3 batches an epoch (drop last): across epochs
        got, want = next(got_s), next(want_s)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    got_s.close()
    want_s.close()


def _which(batch, imgs):
    """Per image of `batch`: (index into imgs, flipped?)."""
    out = []
    for b in batch:
        hits = [(i, False) for i, im in enumerate(imgs) if np.array_equal(b, im)]
        hits += [(i, True) for i, im in enumerate(imgs) if np.array_equal(b, im[..., ::-1])]
        assert len(hits) >= 1, "a staged batch holds an image that is not in the dataset"
        out.append(hits[0])
    return out


def test_device_data_stream_order_matches_rick_tpu(tmp_path):
    """The epoch order is rick_tpu's (numpy, one seed); the flips come from
    each package's own generator, so each image is compared up to a flip."""
    rng = np.random.default_rng(6)
    port, jax_path = write_stores(tmp_path, [smooth_image(rng, 16, 16, 3) for _ in range(5)])
    imgs = ImageDataset(port, 16, flip=False)
    imgs = [imgs.get(i, None) for i in range(5)]
    got_s = device_data_stream(ImageDataset(port, 16), 2, seed=9, device="cpu")
    want_s = j_device_data_stream(JImageDataset(jax_path, 16), 2, seed=9)
    flips = []
    for _ in range(6):
        got, want = _which(next(got_s).numpy(), imgs), _which(np.asarray(next(want_s)), imgs)
        assert [i for i, _ in got] == [i for i, _ in want]
        flips += [f for _, f in got]
    assert any(flips) and not all(flips)


def test_get_nsamples_matches_rick_tpu(tmp_path):
    rng = np.random.default_rng(8)
    port, jax_path = write_stores(tmp_path, [smooth_image(rng, 16, 16, 3) for _ in range(6)])
    got = get_nsamples(ImageDataset(port, 16, flip=True), 4, seed=1)
    want = j_get_nsamples(JImageDataset(jax_path, 16, flip=True), 4, seed=1)
    assert got.shape == (4, 3, 16, 16)
    np.testing.assert_array_equal(got, want)


def test_save_image_grid_without_pil(tmp_path):
    """The grid is written with PIL unimportable, and its pixels are
    rick_tpu's."""
    imgs = np.random.default_rng(3).uniform(-1.2, 1.2, (5, 3, 8, 8)).astype(np.float32)
    np.save(tmp_path / "imgs.npy", imgs)
    code = (
        "import sys, numpy as np, torch\n"
        "sys.modules['PIL'] = None\n"
        "from rick_tpu_torch.utils import save_image_grid\n"
        f"imgs = torch.from_numpy(np.load({str(tmp_path / 'imgs.npy')!r}))\n"
        f"save_image_grid(imgs, {str(tmp_path / 'port.png')!r}, nrow=3)\n"
        "assert 'PIL.Image' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(REPO)})
    j_save_image_grid(imgs, str(tmp_path / "jax.png"), nrow=3)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax.png")))
    np.testing.assert_array_equal(decode_png((tmp_path / "port.png").read_bytes()), got)
