"""`decode_image`: PNG or JPEG bytes -> (H, W, 3) uint8 RGB, the port's
counterpart of `rick_tpu.data.loader._decode` (which takes whatever cv2 or
PIL opens).  The record stores, the FID CLI's image folders, the few-shot
inputs of `prepare_data` and the intra-LPIPS cluster centers all read
through it."""

from __future__ import annotations

import numpy as np

from rick_tpu_torch.data.jpeg import SOI, decode_jpeg
from rick_tpu_torch.data.png import SIGNATURE, decode_png


def decode_image(blob: bytes, *, name: str = "the blob") -> np.ndarray:
    """By signature: PNG through `decode_png`, JPEG through `decode_jpeg`;
    anything else raises ValueError naming `name`."""
    blob = bytes(blob)
    if blob.startswith(SIGNATURE):
        return decode_png(blob, name=name)
    if blob.startswith(SOI):
        return decode_jpeg(blob, name=name)
    raise ValueError(f"cannot decode {name}: neither PNG nor JPEG (starts with {blob[:8]!r})")
