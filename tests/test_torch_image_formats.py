"""The port's BMP, TIFF and WebP decoders (`rick_tpu_torch.data.bmp`,
`.tiff`, `.webp`) against PIL's pixels, bitwise, on the CPU.

* every committed fixture (`torch_fixtures/formats`) decodes to the sha256
  of PIL's `Image.open(f).convert("RGB")` pixels in the manifest, and to
  PIL's pixels now; the generator writes the same bytes and manifest again;
* `prepare_data` of the mixed folder (PNG, JPEG, BMP, TIFF, WebP) gives the
  pixels of `rick_tpu.data.prepare.prepare_dataset`'s store, through the
  function and through the CLI;
* files PIL writes at random sizes and settings, each format;
* every variant the decoders refuse raises ValueError naming the file;
* decoding imports no image library.
"""

import hashlib
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rick_tpu_torch.cli import prepare_data
from rick_tpu_torch.data import RecordStore, decode_image, decode_png
from rick_tpu_torch.data.prepare import prepare_dataset
from tests.torch_fixtures import format_writers
from tests.torch_fixtures import make_format_fixtures as fixtures

REPO = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((fixtures.HERE / "manifest.json").read_text())


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _pil(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_decodes_to_pils_pixels(rel):
    blob = (fixtures.HERE / rel).read_bytes()
    want = MANIFEST["files"][rel]
    assert hashlib.sha256(blob).hexdigest() == want["sha256_file"]
    got = decode_image(blob, name=rel)
    assert got.dtype == np.uint8 and list(got.shape) == want["shape"]
    assert _sha(got) == want["sha256_pixels"]
    np.testing.assert_array_equal(got, _pil(blob))


def test_fixtures_have_not_drifted():
    """The generator writes the committed bytes again, and the manifest
    (PIL's pixels, rick_tpu's store of mixed/) is what it computes now."""
    built = fixtures.build()
    assert sorted(built) == [p.relative_to(fixtures.HERE).as_posix() for p in fixtures.fixture_paths(fixtures.HERE)]
    for rel, blob in built.items():
        assert (fixtures.HERE / rel).read_bytes() == blob, rel
    assert fixtures.manifest(fixtures.HERE) == MANIFEST


def _store_sha(path) -> str:
    store = RecordStore(str(path))
    h = hashlib.sha256()
    for i in range(len(store)):
        h.update(np.ascontiguousarray(decode_png(store.get(i))).tobytes())
    store.close()
    return h.hexdigest()


def test_prepare_data_of_the_mixed_folder_equals_rick_tpus_store(tmp_path, capsys):
    want = MANIFEST["mixed_store"]
    n = prepare_dataset(str(fixtures.HERE / "mixed"), str(tmp_path / "a"), size=want["size"], n_worker=1,
                        resample=want["resample"])
    assert n == want["n"] == 6
    assert _store_sha(tmp_path / "a") == want["sha256_pixels"]
    prepare_data.main(["--input_path", str(fixtures.HERE / "mixed"), "--output_path", str(tmp_path / "b"),
                       "--size", str(want["size"]), "--n_worker", "2"])
    assert "wrote 6 images" in capsys.readouterr().out
    assert _store_sha(tmp_path / "b") == want["sha256_pixels"]


def _image(rng, h, w):
    return fixtures.smooth_image(rng, h, w, cells=4)


@pytest.mark.parametrize("seed", range(6))
def test_random_files_pil_writes(seed):
    """Random sizes, contents and settings of each format, as PIL writes them."""
    rng = np.random.default_rng(100 + seed)
    h, w = (int(v) for v in rng.integers(1, 90, 2))
    img = _image(rng, h, w)
    if seed % 2:
        img = np.clip(img.astype(int) + rng.integers(-60, 61, img.shape), 0, 255).astype(np.uint8)
    im = Image.fromarray(img)
    blobs = [
        fixtures.pil_bytes(im, "BMP"),
        fixtures.pil_bytes(im.convert("L"), "BMP"),
        fixtures.pil_bytes(im.quantize(int(rng.integers(2, 256))), "BMP"),
        fixtures.pil_bytes(im, "TIFF", compression=["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"][seed % 4]),
        fixtures.pil_bytes(im.convert("1"), "TIFF", compression=["raw", "packbits"][seed % 2]),
        fixtures.pil_bytes(im, "WEBP", quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7))),
        fixtures.pil_bytes(im, "WEBP", lossless=True, quality=int(rng.integers(0, 101)),
                           method=int(rng.integers(0, 7))),
        fixtures.libwebp_encode(img, float(rng.integers(0, 101)), filter_type=int(rng.integers(0, 2)),
                                filter_sharpness=int(rng.integers(0, 8)), segments=int(rng.integers(1, 5)),
                                partitions=int(rng.integers(0, 4)), method=0),
    ]
    for k, blob in enumerate(blobs):
        np.testing.assert_array_equal(decode_image(blob, name=f"case {k}"), _pil(blob), err_msg=f"case {k}")


def _refused(blob: bytes, match: str, name: str = "shot_3.img"):
    with pytest.raises(ValueError, match=rf"{name.replace('.', '[.]')}.*{match}"):
        decode_image(blob, name=name)


def _bmp(**kw):
    return fixtures.bmp_bytes(3, 2, kw.pop("bits", 24), kw.pop("pixels", bytes(24)), **kw)


def test_bmp_refusals():
    _refused(_bmp(compression=4), "compression 4 an embedded JPEG")
    _refused(_bmp(compression=5), "compression 5 an embedded PNG")
    _refused(_bmp(bits=32, compression=6, header=56, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)), "compression 6")
    _refused(_bmp(bits=2, palette=np.zeros((4, 3), int)), "2 bits per pixel")
    _refused(_bmp(bits=32, compression=3, header=56, masks=(0xFF00, 0xFF, 0xFF0000, 0)), "bitfields")
    _refused(_bmp(bits=16, compression=3, masks=(0xF00, 0xF0, 0xF)), "bitfields")
    _refused(_bmp(bits=8, palette=np.zeros((300, 3), int), colors=300), "palette of 300 entries")
    gray16 = np.repeat(np.arange(16)[:, None], 3, axis=1)
    _refused(_bmp(bits=4, palette=gray16), "4-bit BMP whose 16-entry palette is gray")
    _refused(_bmp(bits=8, palette=np.array([[0, 0, 0], [255, 255, 255]]), colors=2),
             "8-bit BMP whose 2-entry palette is gray")
    _refused(_bmp(bits=24, pixels=bytes(10)), "pixel data truncated")
    _refused(_bmp(bits=8, compression=1, pixels=b"\x02\x05\x00\x01", palette=np.zeros((256, 3), int)),
             "RLE data ends before")
    _refused(_bmp(bits=24, compression=1), "RLE8 at 24 bits")
    _refused(b"BM" + struct.pack("<IHHI", 30, 0, 0, 26) + struct.pack("<I", 12) + b"\x00\x00",
             "truncated in its header")
    _refused(fixtures.bmp_bytes(20000, 20000, 24, bytes(24)), "BMP of 20000x20000 pixels")


def _tif(**kw):
    samples = kw.pop("samples", np.zeros((4, 5, 3), np.uint8))
    return fixtures.tiff_bytes(samples, kw.pop("bits", 8), kw.pop("photometric", 2), **kw)


def _with_tag(blob: bytes, tag: int, values, typ: int = 3) -> bytes:
    """`blob` (little-endian, from tiff_bytes) with `tag` set to `values`
    (at most two SHORTs: they fit in the entry)."""
    (ifd,) = struct.unpack_from("<I", blob, 4)
    (n,) = struct.unpack_from("<H", blob, ifd)
    entries = [blob[ifd + 2 + 12 * i : ifd + 14 + 12 * i] for i in range(n)]
    entries = [e for e in entries if struct.unpack_from("<H", e)[0] != tag]
    value = struct.pack("<" + "H" * len(values), *values).ljust(4, b"\0")
    entries.append(struct.pack("<HHI", tag, typ, len(values)) + value)
    entries.sort()
    return blob[:ifd] + struct.pack("<H", len(entries)) + b"".join(entries) + b"\0\0\0\0"


def test_tiff_refusals():
    base = _tif()
    _refused(_with_tag(base, 259, [7]), "compression 7 [(]JPEG[)]")
    _refused(_with_tag(base, 259, [6]), "old-style JPEG")
    _refused(_with_tag(base, 259, [3]), "CCITT fax 3")
    _refused(_with_tag(base, 259, [4]), "CCITT fax 4")
    _refused(_with_tag(base, 259, [34925]), "LZMA")
    gray = _tif(samples=np.zeros((4, 5, 1), np.uint8), photometric=1)
    _refused(_with_tag(gray, 258, [16]), "1 samples of 16 bits")
    _refused(_with_tag(gray, 339, [3]), "sample format")
    _refused(_with_tag(base, 262, [6]), "YCbCr")
    _refused(_with_tag(_tif(samples=np.zeros((4, 5, 4), np.uint8)), 262, [5]), "CMYK")
    _refused(_tif(samples=np.zeros((4, 5, 4), np.uint8), extras=(1,)), r"extra samples \(1,\)")
    _refused(_with_tag(base, 284, [2]), "planar configuration 2")
    _refused(_with_tag(_tif(samples=np.zeros((4, 5, 1), np.uint8), bits=1, photometric=1), 266, [2]),
             "fill order 2")
    _refused(_with_tag(base, 317, [3]), "predictor 3")
    _refused(b"II+\x00" + bytes(12), "BigTIFF")
    _refused(_tif(compression=5)[:20] + bytes(4) + _tif(compression=5)[24:], "LZW")
    lzw = bytearray(_tif(compression=5))
    lzw[8:10] = b"\x00\x01"  # an old-style (LSB-first) LZW strip starts so
    _refused(bytes(lzw), "LZW data is corrupt or old-style")
    _refused(_tif(compression=8)[:-40], "lies beyond the file|truncated")
    deflated = bytearray(_tif(compression=8, samples=np.arange(60, dtype=np.uint8).reshape(4, 5, 3)))
    deflated[9] ^= 0xFF  # the zlib header's check bits
    _refused(bytes(deflated), "Deflate data is corrupt")
    deflated[9] ^= 0xFF
    deflated[10:14] = b"\xff\xff\xff\xff"  # a block of reserved type 3
    _refused(bytes(deflated), "Deflate data is corrupt")
    packed = _tif(compression=32773, rows_per_strip=2)
    _refused(_with_tag(packed, 278, [1]), "chunks where 4 are needed")
    _refused(_with_tag(base, 278, [0]), "strip of 5x0 pixels")
    tiled = _tif(compression=8, tile=(16, 16))
    _refused(_with_tag(tiled, 322, [0]), "tile of 0x16 pixels")
    _refused(_with_tag(tiled, 323, [0]), "tile of 16x0 pixels")
    _refused(_with_tag(_with_tag(tiled, 322, [65535]), 323, [65535]), "tile of 65535x65535 pixels")
    _refused(_with_tag(_with_tag(base, 256, [65535]), 257, [65535]), "65535x65535 pixels, beyond PIL's")


def test_timing_files_decode_to_pils_pixels():
    """The 512x512 BMP and TIFF files whose decode `chip_smoke.py` times on
    the card's host (written there without PIL, from a cat JPEG's pixels)
    hold the pixels they were written with, which are PIL's."""
    rgb = _pil((REPO / "tests" / "torch_fixtures" / "jpeg" / "cat" / "00.jpg").read_bytes())
    for variant, (blob, want) in format_writers.timing_files(rgb).items():
        got = decode_image(blob, name=variant)
        assert got.shape == (512, 512, 3), variant
        np.testing.assert_array_equal(got, want, err_msg=variant)
        np.testing.assert_array_equal(want, _pil(blob), err_msg=variant)


def test_webp_refusals():
    rng = np.random.default_rng(7)
    frames = [Image.fromarray(_image(rng, 8, 8)) for _ in range(2)]
    anim = io.BytesIO()
    frames[0].save(anim, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    _refused(anim.getvalue(), "animation of 2 frames")
    lossy = fixtures.pil_bytes(frames[0], "WEBP", quality=80)
    inter = bytearray(lossy)
    inter[20] |= 1
    _refused(bytes(inter), "not a key frame")
    _refused(lossy[:-30], "runs past the end")
    cut = bytearray(lossy[:60])
    cut[4:8] = struct.pack("<I", len(cut) - 8)
    cut[16:20] = struct.pack("<I", len(cut) - 20)
    _refused(bytes(cut), "VP8 first partition beyond the data|ends early")
    lossless = bytearray(fixtures.pil_bytes(frames[0], "WEBP", lossless=True))
    lossless[25] ^= 0xFF
    _refused(bytes(lossless), "WebP")
    _refused(fixtures.riff([(b"VP8X", bytes(10)), (b"EXIF", b"xx")]), "0 image bitstreams")
    _refused(fixtures.riff([(b"ICCP", b"xx")]), "begins with chunk")


def test_decoding_imports_no_image_library():
    kinds = ("bmp/rle", "tiff/rgb_tiles", "webp/lossy_q", "webp/lossless_p")
    rels = [r for r in sorted(MANIFEST["files"]) if r.startswith(kinds)]
    code = ("import sys\nfrom rick_tpu_torch.data import decode_image\n"
            f"for p in {[str(fixtures.HERE / r) for r in rels]!r}:\n    decode_image(open(p, 'rb').read())\n"
            "assert not {'PIL', 'cv2', 'jax'} & set(sys.modules), sys.modules.keys()\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
