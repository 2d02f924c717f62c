"""Write the JPEG fixtures of `rick_tpu_torch.data.jpeg` and their manifest.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jpeg_fixtures.py

Every file is encoded by PIL from a seeded numpy image, so running this again
writes the same bytes with the same PIL:

- `jpeg/modes/`: one small file per mode the decoder takes (4:4:4, 4:2:2,
  4:2:0, gray, progressive, restart markers, optimized tables, quality 50
  and 100, odd sizes);
- `jpeg/cat/`: ten 512x512 images at quality 90, 4:2:0, standing in for
  AFHQ-Cat's ten shots (the set ships as JPEG; its files are not in the
  repo);
- `jpeg/manifest.json`: per file, the sha256 of the file and of PIL's
  decoded pixels (`np.asarray(Image.open(f).convert("RGB"))`, HWC uint8),
  and for `cat/` the sha256 of the pixels of `rick_tpu.prepare_dataset`'s
  store at 256px (LANCZOS): every record decoded, in key order.

It needs PIL and `rick_tpu`, so it runs where the CPU tests run, never on the
machine with the card; `tests/test_torch_jpeg.py` recomputes the manifest
and checks that the files and the manifest have not drifted.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent / "jpeg"
CAT_SIZE, CAT_N, STORE_SIZE = 512, 10, 256

# name: (height, width, PIL mode, save options)
MODES = {
    "444.jpg": (40, 56, "RGB", dict(quality=90, subsampling=0)),
    "422.jpg": (40, 56, "RGB", dict(quality=90, subsampling=1)),
    "420.jpg": (40, 56, "RGB", dict(quality=90, subsampling=2)),
    "gray.jpg": (40, 56, "L", dict(quality=90)),
    "progressive.jpg": (48, 64, "RGB", dict(quality=90, subsampling=2, progressive=True)),
    "progressive_gray.jpg": (33, 47, "L", dict(quality=85, progressive=True)),
    "restart_blocks.jpg": (40, 56, "RGB", dict(quality=90, subsampling=2, restart_marker_blocks=1)),
    "restart_rows.jpg": (40, 56, "RGB", dict(quality=90, subsampling=1, restart_marker_rows=1, progressive=True)),
    "optimize.jpg": (40, 56, "RGB", dict(quality=90, subsampling=2, optimize=True)),
    "q50.jpg": (40, 56, "RGB", dict(quality=50, subsampling=2)),
    "q100.jpg": (40, 56, "RGB", dict(quality=100, subsampling=0)),
    "odd_1x1.jpg": (1, 1, "RGB", dict(quality=90, subsampling=2)),
    "odd_7x9.jpg": (7, 9, "RGB", dict(quality=90, subsampling=2)),
    "odd_37x53.jpg": (37, 53, "RGB", dict(quality=75, subsampling=2, progressive=True)),
}


def smooth_image(rng: np.random.Generator, h: int, w: int, cells: int = 16) -> np.ndarray:
    """(h, w, 3) uint8: a random cells x cells image scaled up bicubically."""
    small = rng.integers(0, 256, (cells, cells, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))


def encode(img: np.ndarray, mode: str, options: dict) -> bytes:
    im = Image.fromarray(img)
    if mode == "L":
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, format="JPEG", **options)
    return buf.getvalue()


def build() -> dict:
    """{path relative to jpeg/: bytes} of every fixture."""
    rng = np.random.default_rng(20261017)
    files = {}
    for name, (h, w, mode, options) in MODES.items():
        noisy = smooth_image(rng, h, w).astype(np.int64) + rng.integers(-12, 13, (h, w, 3))
        files[f"modes/{name}"] = encode(np.clip(noisy, 0, 255).astype(np.uint8), mode, options)
    for k in range(CAT_N):
        files[f"cat/{k:02d}.jpg"] = encode(smooth_image(rng, CAT_SIZE, CAT_SIZE),
                                           "RGB", dict(quality=90, subsampling=2))
    return files


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


def manifest(root: Path) -> dict:
    """The manifest of the fixtures under `root` (jpeg/): PIL's pixels per
    file, and `rick_tpu.prepare_dataset`'s store of cat/."""
    from rick_tpu.data.prepare import prepare_dataset

    files = {}
    for path in sorted(p for p in root.rglob("*.jpg")):
        blob = path.read_bytes()
        px = pil_pixels(blob)
        files[path.relative_to(root).as_posix()] = dict(
            shape=list(px.shape), sha256_file=hashlib.sha256(blob).hexdigest(), sha256_pixels=sha256(px))
    with tempfile.TemporaryDirectory() as tmp:
        n = prepare_dataset(str(root / "cat"), tmp + "/store", size=STORE_SIZE, n_worker=1, resample="lanczos")
        cat_store = dict(size=STORE_SIZE, resample="lanczos", n=n,
                         sha256_pixels=store_sha256(tmp + "/store", pil_pixels))
    import PIL

    return dict(pil=PIL.__version__, files=files, cat_store=cat_store)


def main() -> int:
    for rel, blob in build().items():
        path = HERE / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(blob)
    (HERE / "manifest.json").write_text(json.dumps(manifest(HERE), indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in HERE.rglob("*") if p.is_file())
    print(f"wrote {len(list(HERE.rglob('*.jpg')))} JPEGs and manifest.json under {HERE}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
