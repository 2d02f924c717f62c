"""Image grid saving (torchvision `save_image` semantics): unnormalize from
[-1, 1], tile with 2 px padding.  Port of `rick_tpu/utils/images.py`."""

from __future__ import annotations

import numpy as np
import torch


def save_image_grid(imgs: torch.Tensor, path: str, nrow: int = 8, padding: int = 2) -> None:
    """imgs: (N, 3, H, W) in [-1, 1], on any device."""
    from PIL import Image  # not a dependency of the rest of the package

    arr = (imgs.detach().float().cpu() / 2 + 0.5).clamp(0.0, 1.0).numpy()
    n, c, h, w = arr.shape
    rows = (n + nrow - 1) // nrow
    grid = np.zeros((c, rows * (h + padding) + padding, nrow * (w + padding) + padding), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[:, y : y + h, x : x + w] = arr[i]
    Image.fromarray((grid.transpose(1, 2, 0) * 255).round().astype(np.uint8)).save(path)
