"""The port's JPEG decoder against `rick_tpu`'s decode (cv2 or PIL, both
libjpeg-turbo), bitwise: PIL-written files over the sampling, baseline and
progressive, restart intervals, qualities and odd sizes; gray, optimized
tables, hypothesis over sizes and seeds; files whose quantization tables
drive the IDCT far out of range; the color-space decisions; fill bytes.
Each refusal names the file.  The committed fixtures (`torch_fixtures/jpeg`)
against their manifest, recomputed here; and the three readers of image
files besides the loader (the FID CLI's folders, the intra-LPIPS centers)
on JPEG against `rick_tpu`'s."""

import hashlib
import io
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from rick_tpu.cli.fid import _load_images as j_load_images
from rick_tpu.data.loader import _decode as j_decode
from rick_tpu.metrics.intra_lpips import load_cluster_centers as j_load_cluster_centers
from rick_tpu_torch.cli.fid import _load_images
from rick_tpu_torch.data import decode_image, decode_jpeg
from rick_tpu_torch.metrics import load_cluster_centers
from tests.torch_fixtures import make_jpeg_fixtures as fixtures
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def image(seed: int, h: int, w: int) -> np.ndarray:
    """Smooth seeded pixels with noise: blocks with both flat and busy parts."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(h // 6, 2), max(w // 6, 2), 3), dtype=np.uint8)
    big = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR)).astype(np.int64)
    return np.clip(big + rng.integers(-25, 26, (h, w, 3)), 0, 255).astype(np.uint8)


def jpeg(img: np.ndarray, gray: bool = False, **options) -> bytes:
    im = Image.fromarray(img)
    if gray:
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, format="JPEG", **options)
    return buf.getvalue()


def same_as_rick_tpu(blob: bytes) -> None:
    want = j_decode(blob)
    np.testing.assert_array_equal(decode_jpeg(blob), want)
    np.testing.assert_array_equal(decode_image(blob), want)
    np.testing.assert_array_equal(want, np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))


def segments(blob: bytes):
    """(offset, marker, length) of each marker segment up to the first SOS."""
    pos = 2
    while pos < len(blob):
        marker, (length,) = blob[pos + 1], struct.unpack_from(">H", blob, pos + 2)
        yield pos, marker, length
        if marker == 0xDA:
            return
        pos += 2 + length


def without(blob: bytes, marker: int) -> bytes:
    out = blob[:2]
    for pos, m, length in segments(blob):
        if m == 0xDA:
            return out + blob[pos:]
        if m != marker:
            out += blob[pos : pos + 2 + length]
    raise AssertionError("no SOS")


def patched(blob: bytes, marker: int, offset: int, value: int) -> bytes:
    """`value` at byte `offset` of the first `marker` segment's data."""
    out = bytearray(blob)
    pos = next(p for p, m, _ in segments(blob) if m == marker)
    out[pos + 4 + offset] = value
    return bytes(out)


def with_quant(blob: bytes, values, precision: int = 0) -> bytes:
    """Every DQT table replaced by `values` (64, zigzag order) at 8 or 16 bits."""
    out = blob[:2]
    for pos, m, length in segments(blob):
        if m == 0xDA:
            return out + blob[pos:]
        if m != 0xDB:
            out += blob[pos : pos + 2 + length]
            continue
        seg, p, tables = blob[pos + 4 : pos + 2 + length], 0, b""
        while p < len(seg):
            tq = seg[p] & 15
            tables += bytes([precision << 4 | tq]) + np.asarray(values, ">u2" if precision else np.uint8).tobytes()
            p += 1 + (128 if seg[p] >> 4 else 64)
        out += b"\xff\xdb" + struct.pack(">H", 2 + len(tables)) + tables
    raise AssertionError("no SOS")


RESTARTS = {"none": {}, "blocks": {"restart_marker_blocks": 1}, "rows": {"restart_marker_rows": 1}}


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (37, 53)])
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("restart", list(RESTARTS))
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_decode_equals_rick_tpu(subsampling, progressive, restart, quality, size):
    seed = zlib.crc32(repr((subsampling, progressive, restart, quality, size)).encode())
    same_as_rick_tpu(jpeg(image(seed, *size), subsampling=subsampling, progressive=progressive, quality=quality,
                          **RESTARTS[restart]))


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [1, 2], ids=["422", "420"])
def test_narrow_chroma_equals_rick_tpu(subsampling, progressive, width):
    """A chroma plane 1 or 2 samples wide is replicated, not interpolated
    (libjpeg's fancy upsampling needs 3); 3 and more are interpolated."""
    same_as_rick_tpu(jpeg(image(width * 7 + subsampling, 9, width), subsampling=subsampling, progressive=progressive))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (37, 53), (64, 48)])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_gray_equals_rick_tpu(progressive, size):
    same_as_rick_tpu(jpeg(image(size[0], *size), gray=True, progressive=progressive, quality=85))


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"])
def test_optimized_tables_equal_rick_tpu(subsampling, progressive):
    gray = subsampling == "gray"
    options = {} if gray else {"subsampling": subsampling}
    same_as_rick_tpu(jpeg(image(3, 29, 61), gray=gray, optimize=True, progressive=progressive, **options))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), seed=st.integers(0, 2**31), subsampling=st.sampled_from([0, 1, 2]),
       progressive=st.booleans(), quality=st.integers(1, 100), restart=st.sampled_from(list(RESTARTS)))
def test_random_sizes_and_seeds_equal_rick_tpu(h, w, seed, subsampling, progressive, quality, restart):
    same_as_rick_tpu(jpeg(image(seed, h, w), subsampling=subsampling, progressive=progressive, quality=quality,
                          **RESTARTS[restart]))


@pytest.mark.parametrize("table", ["all_255", "scaled_x16", "16bit_4000", "16bit_40000"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_idct_far_out_of_range_equals_rick_tpu(subsampling, progressive, table):
    """Quantization tables that scale the coefficients past 16 bits: the
    dequantized products wrap, the IDCT's passes saturate, the output
    clamps, as libjpeg-turbo's SIMD IDCT does them."""
    blob = jpeg(image(11, 24, 40), subsampling=subsampling, progressive=progressive, quality=60)
    values = {"all_255": ([255] * 64, 0), "scaled_x16": (np.minimum(np.arange(64) * 16 + 16, 255), 0),
              "16bit_4000": ([4000] * 64, 1), "16bit_40000": (np.arange(64) * 600 + 2000, 1)}[table]
    same_as_rick_tpu(with_quant(blob, *values))


def test_color_space_as_libjpeg_decides():
    """JFIF: YCbCr whatever the ids; else Adobe's transform flag (0: RGB);
    else the component ids ('R', 'G', 'B': RGB; others YCbCr)."""
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
    cases = [ids(no_jfif, b"RGB"), ids(base, b"RGB"), adobe(no_jfif, 0), adobe(base, 0), adobe(no_jfif, 1),
             ids(no_jfif, [5, 9, 7])]
    for blob in cases:
        same_as_rick_tpu(blob)
    assert not np.array_equal(decode_jpeg(cases[0]), decode_jpeg(base))  # RGB: no conversion


def test_gray_with_another_encoders_sampling_factors():
    """One component whose SOF says 2x2 (as some encoders write gray 4:2:0)."""
    blob = jpeg(image(9, 19, 23), gray=True, quality=75)
    same_as_rick_tpu(patched(blob, 0xC0, 7, 0x22))


def test_fill_bytes_before_markers():
    blob = jpeg(image(7, 24, 40), subsampling=2, quality=80, restart_marker_blocks=1)
    same_as_rick_tpu(blob.replace(b"\xff\xd0", b"\xff\xff\xff\xd0").replace(b"\xff\xd9", b"\xff\xff\xd9"))


def refused(blob: bytes, match: str) -> None:
    with pytest.raises(ValueError, match=rf"cat_07\.jpg.*{match}"):
        decode_image(blob, name="cat_07.jpg")


def test_refusals_name_the_file_and_what_was_found():
    base = jpeg(image(13, 24, 32), subsampling=2, quality=90)
    refused(base.replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic-coded sequential")
    refused(base.replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless")
    refused(jpeg(image(13, 24, 32), progressive=True).replace(b"\xff\xc2", b"\xff\xca", 1), "arithmetic-coded prog")
    buf = io.BytesIO()
    Image.fromarray(image(13, 24, 32)).convert("CMYK").save(buf, format="JPEG")
    refused(buf.getvalue(), "4 components")
    refused(patched(base, 0xC0, 0, 12), "12-bit")
    refused(patched(base, 0xC0, 7, 0x41), "sampling factors")
    for cut in (len(base) // 2, len(base) - 2, 200):
        refused(base[:cut], "truncated")
    sos = next(p for p, m, n in segments(base) if m == 0xDA)
    start = sos + 2 + struct.unpack_from(">H", base, sos + 2)[0]
    refused(base[:start] + b"\xff\x00" * 40 + base[start + 80 :], "no DC Huffman code matches")
    refused(without(base, 0xC4), "Huffman table 0, which no DHT")
    refused(without(base, 0xDB), "quantization table 0")
    prog = jpeg(image(13, 24, 32), progressive=True)
    scans = [p for p in range(len(prog) - 1) if prog[p : p + 2] == b"\xff\xda"]
    refused(prog[: scans[3]] + b"\xff\xd9", "progressive and its scans leave coefficient")
    with pytest.raises(ValueError, match=r"cat_07\.jpg.*neither PNG nor JPEG"):
        decode_image(b"BM" + bytes(60), name="cat_07.jpg")


# ---- the committed fixtures


def test_fixtures_decode_to_the_manifest():
    root = fixtures.HERE
    man = json.loads((root / "manifest.json").read_text())
    assert len(man["files"]) == len(fixtures.MODES) + fixtures.CAT_N
    for rel, entry in man["files"].items():
        got = decode_jpeg((root / rel).read_bytes(), name=rel)
        assert list(got.shape) == entry["shape"], rel
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256_pixels"], rel


def test_fixtures_have_not_drifted():
    """The generator writes the committed bytes again, and the manifest
    recomputed from PIL and `rick_tpu.prepare_dataset` is the committed one."""
    root = fixtures.HERE
    built = fixtures.build()
    assert sorted(built) == sorted(p.relative_to(root).as_posix() for p in root.rglob("*.jpg"))
    for rel, blob in built.items():
        assert (root / rel).read_bytes() == blob, rel
    assert fixtures.manifest(root) == json.loads((root / "manifest.json").read_text())
    assert sum(p.stat().st_size for p in root.rglob("*") if p.is_file()) <= 600_000


# ---- the FID CLI's folders and the intra-LPIPS centers


@pytest.mark.parametrize("size", [16, 40])
def test_fid_cli_reads_a_jpeg_folder_as_rick_tpu(tmp_path, size):
    """A folder of JPEG and PNG files at the transform's size (the port's
    resize differs from cv2's by a level in places, tested elsewhere), and
    one file per side in a mode the resize leaves alone."""
    for k, (subsampling, progressive) in enumerate([(0, False), (1, True), (2, False), (2, True)]):
        img = image(40 + k, size, size + 3 * k)
        (tmp_path / f"{k}.jpg").write_bytes(jpeg(img, subsampling=subsampling, progressive=progressive))
    (tmp_path / "4.jpeg").write_bytes(jpeg(image(45, size, size), gray=True))
    Image.fromarray(image(46, size, size)).save(tmp_path / "5.png")
    got, want = _load_images(str(tmp_path), size), j_load_images(str(tmp_path), size)
    assert got.shape == want.shape == (6, 3, size, size)
    np.testing.assert_array_equal(got, want)


def test_intra_lpips_centers_from_jpeg_as_rick_tpu(tmp_path):
    """`c{k}/center.png` holding JPEG bytes (as a center copied from a JPEG
    training set is): both packages decode what the bytes are."""
    for k in range(3):
        (tmp_path / f"c{k}").mkdir()
        (tmp_path / f"c{k}" / "center.png").write_bytes(jpeg(image(60 + k, 16, 16), subsampling=k, quality=80))
    got, want = load_cluster_centers(str(tmp_path), k=3, size=16), j_load_cluster_centers(str(tmp_path), k=3,
                                                                                            size=16)
    assert got.shape == (3, 3, 16, 16)
    np.testing.assert_array_equal(got, want)


def test_decoding_imports_no_image_library():
    code = ("import sys\nfrom rick_tpu_torch.data import decode_image\n"
            f"decode_image(open({str(fixtures.HERE / 'modes' / '420.jpg')!r}, 'rb').read())\n"
            "assert not {'PIL', 'cv2', 'jax'} & set(sys.modules), sys.modules.keys()\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
