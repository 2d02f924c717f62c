"""LPIPS perceptual distance with the VGG16 trunk (the lpips package's
net='vgg'), the distance of the intra-cluster LPIPS diversity metric.  Port
of `rick_tpu/metrics/lpips.py`.

Inputs in [-1, 1] go through the lpips scaling layer, then VGG16's features;
the activations after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 are each
normalized over channels (f / (||f|| + 1e-10): eps on the norm, as
`lpips.normalize_tensor`), their squared differences weighted by the
non-negative 'lin' weights of the layer and summed over channels, averaged
over space, and summed over the five layers.  `RICK_LPIPS_WEIGHTS` names the
lpips vgg `.pth` of 'lin' weights; unset, each layer weighs its channels
uniformly by 1/C, a valid but unlearned distance.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from rick_tpu_torch.metrics.vgg import VGG16, default_vgg16_params, vgg16_from_params

# lpips slices torchvision's features at [0:4], [4:9], [9:16], [16:23],
# [23:30]: the activations after the 2nd, 4th, 7th, 10th and 13th conv's ReLU
# (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), not relu4_2 / relu5_2
_TAP_AFTER_CONV = {2, 4, 7, 10, 13}
_TAP_CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def load_lpips_lin_weights(path: str) -> List[torch.Tensor]:
    """The five layers' 'lin' weights, (C,) f32 each, from an lpips `.pth`
    in either key layout (`lin{i}.model.1.weight` or
    `lins.{i}.model.1.weight`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    lins = []
    for i in range(5):
        key = next((k for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight") if k in sd), None)
        if key is None:
            raise KeyError(f"lin{i} weights not found in {path}")
        lins.append(sd[key].float().reshape(-1))
    return lins


def default_lin_weights() -> List[torch.Tensor]:
    """The weights at `RICK_LPIPS_WEIGHTS` when it is set (a missing file
    raises, where `rick_tpu` falls back to the uniform weights), else 1/C
    for each channel of each layer."""
    path = os.environ.get("RICK_LPIPS_WEIGHTS", "")
    if not path:
        return [torch.full((c,), 1.0 / c) for c in _TAP_CHANNELS]
    if not os.path.exists(path):
        raise FileNotFoundError(f"RICK_LPIPS_WEIGHTS names {path!r}, which does not exist")
    return load_lpips_lin_weights(path)


def vgg_taps(vgg: VGG16, x: torch.Tensor) -> List[torch.Tensor]:
    """VGG16's activations at the five LPIPS taps of NCHW images in [-1, 1]."""
    dtype = vgg.features[0].weight.dtype
    shift = torch.tensor(_SHIFT, dtype=dtype, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=dtype, device=x.device).reshape(1, 3, 1, 1)
    x = (x.to(dtype) - shift) / scale
    taps, conv_i = [], 0
    for layer in vgg.features:
        x = layer(x)
        if isinstance(layer, torch.nn.ReLU):
            conv_i += 1
            if conv_i in _TAP_AFTER_CONV:
                taps.append(x)
                if conv_i == max(_TAP_AFTER_CONV):
                    break
    return taps


def normalize_taps(taps: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tap unit-normalized over channels, eps on the norm."""
    return [f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True)) + 1e-10) for f in taps]


def lpips_from_normalized(n0: List[torch.Tensor], n1: List[torch.Tensor], lin_weights) -> torch.Tensor:
    """LPIPS per pair (N,) from the two sides' normalized taps."""
    total = 0.0
    for a, b, w in zip(n0, n1, lin_weights):
        w = torch.as_tensor(w).to(device=a.device, dtype=a.dtype).reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((a - b) ** 2 * w, dim=1), dim=(1, 2))
    return total


def lpips_distance(x0: torch.Tensor, x1: torch.Tensor, *, vgg: Optional[VGG16] = None,
                   lin_weights=None) -> torch.Tensor:
    """LPIPS(x0, x1) per pair, (N,); inputs (N, 3, H, W) in [-1, 1].  `vgg`
    defaults to `default_vgg16_params()` on x0's device, `lin_weights` to
    `default_lin_weights()`."""
    if vgg is None:
        vgg = vgg16_from_params(default_vgg16_params(), device=x0.device)
    if lin_weights is None:
        lin_weights = default_lin_weights()
    n0 = normalize_taps(vgg_taps(vgg, x0))
    n1 = normalize_taps(vgg_taps(vgg, x1))
    return lpips_from_normalized(n0, n1, lin_weights)
