"""Write the BMP, TIFF and WebP fixtures of `rick_tpu_torch.data` and their
manifest.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_format_fixtures.py

Every file is made from a seeded numpy image, by PIL where PIL writes the
variant and byte by byte by `format_writers.py` where it does not (the BMP
core and v2-v5 headers, 4 and 16-bit BMP, bitfields, top-down rows, RLE8 and
RLE4; TIFF tiles, big-endian files, PackBits and LZW; a WebP animation of
one frame), or by PIL's own libwebp through ctypes for the encoder settings
PIL does not pass on, so running this again writes the same bytes with the
same PIL:

- `formats/bmp/`, `formats/tiff/`, `formats/webp/`: one small file per
  variant the decoders take, odd sizes (1x1, 7x9, 37x53) among them, and
  one lossy and one lossless 512x512 WebP whose decode `chip_smoke.py`
  times;
- `formats/mixed/`: a folder of every format `prepare_data` takes
  (PNG, JPEG, BMP, TIFF, WebP) in class folders;
- `formats/manifest.json`: per file, the sha256 of the file and of PIL's
  decoded pixels (`np.asarray(Image.open(f).convert("RGB"))`, HWC uint8),
  and the sha256 of the pixels of `rick_tpu.prepare_dataset`'s store of
  `mixed/` at 256px (LANCZOS): every record decoded, in key order.

It needs PIL and `rick_tpu`, so it runs where the CPU tests run, never on the
machine with the card; `tests/test_torch_image_formats.py` recomputes the
manifest and checks that the files and the manifest have not drifted.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

if __name__ == "__main__":  # run as a script: the repo's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from tests.torch_fixtures.format_writers import (  # noqa: E402
    bmp_bytes,
    one_frame_animation,
    packed_rows,
    rgb_rows,
    riff,
    rle_bytes,
    rle_with_delta,
    rows16,
    tiff_bytes,
)

HERE = Path(__file__).resolve().parent / "formats"
STORE_SIZE = 256
SIZES = {"1x1": (1, 1), "7x9": (7, 9), "37x53": (37, 53)}


def smooth_image(rng: np.random.Generator, h: int, w: int, cells: int = 6) -> np.ndarray:
    """(h, w, 3) uint8: a random cells x cells image scaled up bicubically, plus noise."""
    small = rng.integers(0, 256, (cells, cells, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC)).astype(np.int64)
    return np.clip(img + rng.integers(-10, 11, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_bytes(im: Image.Image, fmt: str, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **options)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp_fixtures(rng) -> dict:
    files = {}
    img = {k: smooth_image(rng, h, w) for k, (h, w) in SIZES.items()}
    for k in SIZES:
        files[f"bmp/rgb24_{k}.bmp"] = pil_bytes(Image.fromarray(img[k]), "BMP")
    h, w = SIZES["37x53"]
    base = img["37x53"]
    files["bmp/pil_1bit.bmp"] = pil_bytes(Image.fromarray(base).convert("1"), "BMP")
    files["bmp/pil_gray.bmp"] = pil_bytes(Image.fromarray(base).convert("L"), "BMP")
    files["bmp/pil_p8.bmp"] = pil_bytes(Image.fromarray(base).quantize(60), "BMP")
    files["bmp/pil_rgba.bmp"] = pil_bytes(Image.fromarray(np.dstack([base, rng.integers(0, 256, (h, w), np.uint8)]),
                                                          "RGBA"), "BMP")
    pal16 = rng.integers(0, 256, (16, 3))
    idx16 = rng.integers(0, 16, (h, w))
    files["bmp/p4.bmp"] = bmp_bytes(w, h, 4, packed_rows(idx16, 4), palette=pal16)
    files["bmp/p4_7x9_short_palette.bmp"] = bmp_bytes(  # indices beyond the 5 entries read black
        9, 7, 4, packed_rows(idx16[:7, :9], 4), palette=pal16[:5], colors=5)
    pal2 = rng.integers(0, 256, (2, 3))
    files["bmp/p1_color.bmp"] = bmp_bytes(w, h, 1, packed_rows(idx16 & 1, 1), palette=pal2)
    pal256 = rng.integers(0, 256, (256, 3))
    idx256 = rng.integers(0, 256, (h, w))
    files["bmp/p8_core.bmp"] = bmp_bytes(w, h, 8, packed_rows(idx256, 8), header=12, palette=pal256)
    files["bmp/rgb24_core_7x9.bmp"] = bmp_bytes(9, 7, 24, rgb_rows(img["7x9"], (2, 1, 0), 3), header=12)
    files["bmp/rgb24_top_down.bmp"] = bmp_bytes(w, h, 24, rgb_rows(base, (2, 1, 0), 3, top_down=True),
                                                top_down=True)
    files["bmp/p8_top_down.bmp"] = bmp_bytes(w, h, 8, packed_rows(idx256, 8, top_down=True), palette=pal256,
                                             top_down=True)
    files["bmp/rgb555.bmp"] = bmp_bytes(w, h, 16, rows16(base, (10, 5, 0), (5, 5, 5)))
    files["bmp/rgb565_bitfields.bmp"] = bmp_bytes(w, h, 16, rows16(base, (11, 5, 0), (5, 6, 5)), compression=3,
                                                  masks=(0xF800, 0x7E0, 0x1F))
    files["bmp/rgb555_bitfields_v4.bmp"] = bmp_bytes(w, h, 16, rows16(base, (10, 5, 0), (5, 5, 5)), header=108,
                                                     compression=3, masks=(0x7C00, 0x3E0, 0x1F, 0))
    files["bmp/bgrx32.bmp"] = bmp_bytes(w, h, 32, rgb_rows(base, (2, 1, 0), 4, filler=77))
    files["bmp/rgba32_bitfields_v5.bmp"] = bmp_bytes(w, h, 32, rgb_rows(base, (0, 1, 2), 4, filler=200), header=124,
                                                     compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    files["bmp/abgr32_bitfields_v3.bmp"] = bmp_bytes(w, h, 32, rgb_rows(base, (3, 2, 1), 4, filler=9), header=56,
                                                     compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF))
    files["bmp/xbgr32_bitfields_v2.bmp"] = bmp_bytes(w, h, 32, rgb_rows(base, (3, 2, 1), 4), header=52,
                                                     compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00))
    files["bmp/bgrx32_bitfields_info.bmp"] = bmp_bytes(9, 7, 32, rgb_rows(img["7x9"], (2, 1, 0), 4), compression=3,
                                                       masks=(0xFF0000, 0xFF00, 0xFF))
    runs = np.repeat(rng.integers(0, 256, (h, (w + 5) // 6)), 6, axis=1)[:, :w]
    runs[:, 20:29] = idx256[:, 20:29]  # literal stretches
    files["bmp/rle8.bmp"] = bmp_bytes(w, h, 8, rle_bytes(runs, False), compression=1, palette=pal256)
    files["bmp/rle8_delta_7x9.bmp"] = bmp_bytes(9, 7, 8, rle_with_delta(runs[:7, :9]), compression=1, palette=pal256)
    runs4 = runs % 16
    files["bmp/rle4.bmp"] = bmp_bytes(w, h, 4, rle_bytes(runs4, True), compression=2, palette=pal16)
    return files


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def tiff_fixtures(rng) -> dict:
    files = {}
    img = {k: smooth_image(rng, h, w) for k, (h, w) in SIZES.items()}
    for k in SIZES:
        files[f"tiff/pil_rgb_{k}.tiff"] = pil_bytes(Image.fromarray(img[k]), "TIFF")
    base = img["37x53"]
    h, w = base.shape[:2]
    rgb = Image.fromarray(base)
    rgba = Image.fromarray(np.dstack([base, rng.integers(0, 256, (h, w), np.uint8)]), "RGBA")
    for comp in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"):
        files[f"tiff/pil_rgb_{comp}.tiff"] = pil_bytes(rgb, "TIFF", compression=comp)
    files["tiff/pil_rgb_lzw_predictor.tiff"] = pil_bytes(rgb, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    files["tiff/pil_rgba_deflate.tiff"] = pil_bytes(rgba, "TIFF", compression="tiff_adobe_deflate")
    files["tiff/pil_rgba.tiff"] = pil_bytes(rgba, "TIFF")
    files["tiff/pil_gray_lzw.tiff"] = pil_bytes(rgb.convert("L"), "TIFF", compression="tiff_lzw")
    files["tiff/pil_1bit.tiff"] = pil_bytes(rgb.convert("1"), "TIFF")
    files["tiff/pil_1bit_packbits.tiff"] = pil_bytes(rgb.convert("1"), "TIFF", compression="packbits")
    files["tiff/pil_p8_lzw.tiff"] = pil_bytes(rgb.quantize(40), "TIFF", compression="tiff_lzw")
    files["tiff/pil_la.tiff"] = pil_bytes(rgba.convert("LA"), "TIFF")
    gray = base[:, :, :1]
    files["tiff/gray_white_is_zero.tiff"] = tiff_bytes(gray, 8, 0, compression=32773, rows_per_strip=5)
    files["tiff/bilevel_white_is_zero_lzw.tiff"] = tiff_bytes((gray > 128).astype(np.uint8), 1, 0, compression=5,
                                                              rows_per_strip=4)
    files["tiff/rgb_tiles_lzw_predictor.tiff"] = tiff_bytes(base, 8, 2, compression=5, predictor=2, tile=(16, 16))
    files["tiff/rgb_tiles_deflate_be.tiff"] = tiff_bytes(base, 8, 2, compression=32946, tile=(32, 16), order=">")
    files["tiff/rgba_tiles_packbits.tiff"] = tiff_bytes(np.asarray(rgba), 8, 2, compression=32773, tile=(16, 32),
                                                        extras=(2,))
    files["tiff/rgbx_strips_be.tiff"] = tiff_bytes(np.asarray(rgba), 8, 2, rows_per_strip=7, order=">", extras=(0,))
    files["tiff/gray_predictor_deflate_7x9.tiff"] = tiff_bytes(img["7x9"][:, :, 1:2], 8, 1, compression=8,
                                                               predictor=2, rows_per_strip=3)
    for bits in (1, 2, 4):
        cmap = rng.integers(0, 65536, (1 << bits, 3))
        idx = rng.integers(0, 1 << bits, (h, w, 1))
        files[f"tiff/palette{bits}_strips.tiff"] = tiff_bytes(idx.astype(np.uint8), bits, 3, compression=5,
                                                              rows_per_strip=8, colormap=cmap)
    files["tiff/palette8_tiles_be.tiff"] = tiff_bytes(rng.integers(0, 256, (h, w, 1)).astype(np.uint8), 8, 3,
                                                      tile=(16, 16), order=">",
                                                      colormap=rng.integers(0, 65536, (256, 3)))
    return files


# ---------------------------------------------------------------------------
# WebP: PIL, and libwebp's encoder (PIL's copy) through ctypes for the
# settings PIL does not pass on: the simple loop filter, no loop filter,
# sharpness, one segment, several token partitions
# ---------------------------------------------------------------------------

_ABI = 0x020F  # WEBP_ENCODER_ABI_VERSION of libwebp 1.x


class _Config(ctypes.Structure):
    _fields_ = [("lossless", ctypes.c_int), ("quality", ctypes.c_float), ("method", ctypes.c_int),
                ("image_hint", ctypes.c_int), ("target_size", ctypes.c_int), ("target_PSNR", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in (
            "segments sns_strength filter_strength filter_sharpness filter_type autofilter alpha_compression "
            "alpha_filtering alpha_quality pass show_compressed preprocessing partitions partition_limit "
            "emulate_jpeg_size thread_level low_memory near_lossless exact use_delta_palette use_sharp_yuv qmin "
            "qmax").split()]


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 1)]


class _Picture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
        ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
        ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
        ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
        ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
        ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
        ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2)]


def libwebp_encode(img: np.ndarray, quality: float = 80.0, **fields) -> bytes:
    """A lossy WebP of (h, w, 3) uint8 by PIL's libwebp with WebPConfig `fields` set."""
    import glob

    import PIL
    from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies)

    lib = ctypes.CDLL(glob.glob(str(Path(PIL.__file__).parent.parent / "pillow.libs" / "libwebp-*.so*"))[0])
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), _ABI)
    for k, v in fields.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), fields
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    h, w, _ = img.shape
    pic.width, pic.height = w, h
    px = np.ascontiguousarray(img)
    assert lib.WebPPictureImportRGB(ctypes.byref(pic), px.ctypes.data_as(ctypes.c_void_p), w * 3)
    wr = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.cast(ctypes.pointer(wr), ctypes.c_void_p).value
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    lib.WebPPictureFree(ctypes.byref(pic))
    assert ok, pic.error_code
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    return out


def webp_fixtures(rng) -> dict:
    files = {}
    img = {k: smooth_image(rng, h, w) for k, (h, w) in SIZES.items()}
    for k in SIZES:
        files[f"webp/lossy_{k}.webp"] = pil_bytes(Image.fromarray(img[k]), "WEBP", quality=80)
        files[f"webp/lossless_{k}.webp"] = pil_bytes(Image.fromarray(img[k]), "WEBP", lossless=True)
    h, w = 96, 112
    base = smooth_image(rng, h, w, cells=12)
    noisy = np.clip(base.astype(np.int64) + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
    alpha = rng.integers(0, 256, (h, w), np.uint8)
    alpha[:8] = 0
    for q in (5, 50, 95):
        files[f"webp/lossy_q{q}.webp"] = pil_bytes(Image.fromarray(noisy), "WEBP", quality=q, method=4)
    files["webp/lossy_q100_m6.webp"] = pil_bytes(Image.fromarray(base), "WEBP", quality=100, method=6)
    files["webp/lossy_alpha.webp"] = pil_bytes(Image.fromarray(np.dstack([noisy, alpha]), "RGBA"), "WEBP",
                                               quality=70)
    files["webp/lossless_alpha_exact.webp"] = pil_bytes(Image.fromarray(np.dstack([noisy, alpha]), "RGBA"), "WEBP",
                                                        lossless=True, exact=True)
    files["webp/lossless_fast.webp"] = pil_bytes(Image.fromarray(noisy), "WEBP", lossless=True, quality=0, method=0)
    files["webp/lossless_best.webp"] = pil_bytes(Image.fromarray(base), "WEBP", lossless=True, quality=100, method=6)
    few = np.asarray(Image.fromarray(base).quantize(12).convert("RGB"))  # a palette (colour indexing)
    files["webp/lossless_palette.webp"] = pil_bytes(Image.fromarray(few), "WEBP", lossless=True)
    files["webp/libwebp_simple_filter.webp"] = libwebp_encode(noisy, 60, filter_type=0, filter_strength=80)
    files["webp/libwebp_no_filter.webp"] = libwebp_encode(noisy, 60, filter_strength=0)
    files["webp/libwebp_sharpness7.webp"] = libwebp_encode(noisy, 40, filter_sharpness=7, filter_strength=100)
    files["webp/libwebp_one_segment.webp"] = libwebp_encode(noisy, 70, segments=1)
    files["webp/libwebp_8_partitions.webp"] = libwebp_encode(noisy, 70, partitions=3, method=0)
    files["webp/libwebp_2_partitions_simple.webp"] = libwebp_encode(noisy, 30, partitions=1, low_memory=1,
                                                                    filter_type=0)
    files["webp/anim_one_frame_lossy.webp"] = one_frame_animation(files["webp/lossy_7x9.webp"], (20, 15), (4, 6))
    files["webp/anim_one_frame_lossless.webp"] = one_frame_animation(files["webp/lossless_37x53.webp"], (53, 37),
                                                                     (0, 0))
    return files


def webp_timing_fixtures() -> dict:
    """One lossy and one lossless 512x512 WebP, each a few tens of KB, whose
    decode `chip_smoke.py` times: the lossy one a smooth image with noise,
    the lossless one a smoother image cut to 5 bits per channel (thousands of
    colours, so no colour indexing)."""
    rng = np.random.default_rng(512)
    lossy = smooth_image(rng, 512, 512, cells=16)
    lossless = np.asarray(Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).resize((512, 512),
                                                                                                  Image.BICUBIC))
    return {"webp/lossy_512.webp": pil_bytes(Image.fromarray(lossy), "WEBP", quality=80),
            "webp/lossless_512.webp": pil_bytes(Image.fromarray(lossless & 0xF8), "WEBP", lossless=True)}


# ---------------------------------------------------------------------------
# the mixed folder and the manifest
# ---------------------------------------------------------------------------


def mixed_fixtures(rng) -> dict:
    files = {}
    for i, (ext, fmt, options) in enumerate([("png", "PNG", {}), ("jpg", "JPEG", dict(quality=90)),
                                             ("bmp", "BMP", {}), ("tiff", "TIFF", dict(compression="tiff_lzw")),
                                             ("webp", "WEBP", dict(quality=85)), ("webp", "WEBP", dict(lossless=True))]):
        h, w = (40, 48) if i % 2 else (45, 36)
        files[f"mixed/c{i % 2}/{i:02d}.{ext}"] = pil_bytes(Image.fromarray(smooth_image(rng, h, w)), fmt, **options)
    return files


def build() -> dict:
    """{path relative to formats/: bytes} of every fixture."""
    rng = np.random.default_rng(20261018)
    return {**bmp_fixtures(rng), **tiff_fixtures(rng), **webp_fixtures(rng), **mixed_fixtures(rng),
            **webp_timing_fixtures()}


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pil_pixels(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def store_sha256(store_path: str, decode) -> str:
    """sha256 over the decoded pixels of every record of a store, in key order."""
    from rick_tpu.data.store import open_image_store

    store = open_image_store(store_path)
    h = hashlib.sha256()
    for i in range(len(store)):
        h.update(np.ascontiguousarray(decode(store.get(i))).tobytes())
    return h.hexdigest()


def fixture_paths(root: Path):
    return sorted(p for p in root.rglob("*") if p.is_file() and p.name != "manifest.json")


def manifest(root: Path) -> dict:
    """The manifest of the fixtures under `root` (formats/): PIL's pixels per
    file, and `rick_tpu.prepare_dataset`'s store of mixed/."""
    from rick_tpu.data.prepare import prepare_dataset

    files = {}
    for path in fixture_paths(root):
        blob = path.read_bytes()
        px = pil_pixels(blob)
        files[path.relative_to(root).as_posix()] = dict(
            shape=list(px.shape), sha256_file=hashlib.sha256(blob).hexdigest(), sha256_pixels=sha256(px))
    with tempfile.TemporaryDirectory() as tmp:
        n = prepare_dataset(str(root / "mixed"), tmp + "/store", size=STORE_SIZE, n_worker=1, resample="lanczos")
        mixed_store = dict(size=STORE_SIZE, resample="lanczos", n=n,
                           sha256_pixels=store_sha256(tmp + "/store", pil_pixels))
    import PIL

    return dict(pil=PIL.__version__, files=files, mixed_store=mixed_store)


def main() -> int:
    for rel, blob in build().items():
        path = HERE / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(blob)
    (HERE / "manifest.json").write_text(json.dumps(manifest(HERE), indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in HERE.rglob("*") if p.is_file())
    print(f"wrote {len(fixture_paths(HERE))} files and manifest.json under {HERE}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
