"""Image grid saving (torchvision `save_image` semantics): unnormalize from
[-1, 1], tile with 2 px padding, write a PNG with the port's encoder
(`data/png.py`; no PIL).  Port of `rick_tpu/utils/images.py`: the same
pixels."""

from __future__ import annotations

import numpy as np
import torch

from rick_tpu_torch.data.png import encode_png


def save_image_grid(imgs: torch.Tensor, path: str, nrow: int = 8, padding: int = 2) -> None:
    """imgs: (N, 3, H, W) in [-1, 1], on any device."""
    arr = (imgs.detach().float().cpu() / 2 + 0.5).clamp(0.0, 1.0).numpy()
    n, c, h, w = arr.shape
    rows = (n + nrow - 1) // nrow
    grid = np.zeros((c, rows * (h + padding) + padding, nrow * (w + padding) + padding), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[:, y : y + h, x : x + w] = arr[i]
    with open(path, "wb") as f:
        f.write(encode_png((grid.transpose(1, 2, 0) * 255).round().astype(np.uint8)))
