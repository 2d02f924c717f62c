"""torch-convention image resizes of the metric extractors.  Port of
`rick_tpu/metrics/resize.py`.

The reference's metric wrappers resize with `F.interpolate`:
  * FID: bilinear to 299, align_corners=False, no antialias;
  * P&R: the legacy default 'nearest' to 224.
The JAX package rebuilds those conventions from index math; here each is the
one call it copies.  Both pass the input through when the size already
matches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(x, (out_h, out_w), mode='bilinear', align_corners=False),
    no antialias.  x: (N, C, H, W)."""
    if x.shape[2] == out_h and x.shape[3] == out_w:
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=False)


def nearest_resize_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(x, (out_h, out_w)) in the legacy 'nearest' mode."""
    if x.shape[2] == out_h and x.shape[3] == out_w:
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")
