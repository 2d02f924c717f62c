"""`decode_image`: PNG, JPEG, BMP, TIFF or WebP bytes -> (H, W, 3) uint8
RGB, the port's counterpart of `rick_tpu.data.loader._decode` and of PIL's
`Image.open(...).convert("RGB")` in `rick_tpu.data.prepare`.  The record stores, the FID CLI's image folders, the few-shot
inputs of `prepare_data` and the intra-LPIPS cluster centers all read
through it."""

from __future__ import annotations

import numpy as np

from rick_tpu_torch.data import bmp, tiff, webp
from rick_tpu_torch.data.jpeg import SOI, decode_jpeg
from rick_tpu_torch.data.png import SIGNATURE, decode_png


def decode_image(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """By signature: PNG (`decode_png`), JPEG (`decode_jpeg`), BMP
    (`decode_bmp`), TIFF (`decode_tiff`) or WebP (`decode_webp`); anything
    else raises ValueError naming `name`."""
    blob = bytes(blob)
    if blob.startswith(SIGNATURE):
        return decode_png(blob, name=name)
    if blob.startswith(SOI):
        return decode_jpeg(blob, name=name)
    if bmp.is_bmp(blob):
        return bmp.decode_bmp(blob, name=name)
    if blob.startswith(tiff.SIGNATURES):
        return tiff.decode_tiff(blob, name=name)
    if webp.is_webp(blob):
        return webp.decode_webp(blob, name=name)
    raise ValueError(f"cannot decode {name}: neither PNG nor JPEG, nor BMP, TIFF or WebP (starts with {blob[:8]!r})")
