"""LeNet5 features, the reference's alternative FID feature space
(`gan_metrics/fid_score.py:255-263`, model `gan_metrics/models/lenet.py`).
Port of `rick_tpu/metrics/lenet.py`.

`load_lenet_params` reads the reference's `lenet.pth`, which this repo does
not ship; `lenet_features` gives the 84-d tanh activations of f6 of
grayscale 32x32 inputs in the caller's range (`LeNet5.extract_features`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def load_lenet_params(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def lenet_features(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(N, 84) features of x (N, 1, 32, 32); `params` on x's device."""

    def conv(x, name):
        return torch.tanh(F.conv2d(x, params[f"convnet.{name}.weight"], params[f"convnet.{name}.bias"]))

    x = F.max_pool2d(conv(x, "c1"), kernel_size=2, stride=2, padding=1)
    x = F.max_pool2d(conv(x, "c3"), kernel_size=2, stride=2, padding=1)
    x = conv(x, "c5").flatten(1)
    return torch.tanh(F.linear(x, params["fc.f6.weight"], params["fc.f6.bias"]))
