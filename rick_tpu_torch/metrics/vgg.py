"""VGG16 (torchvision's config D): the fc2 feature extractor of improved
precision and recall, and the trunk whose activations LPIPS taps.  Port of
`rick_tpu/metrics/vgg.py`.

Parameter names are torchvision's flat keys (`features.N.weight` / `.bias`
of the 13 convs, `classifier.0.*` and `classifier.3.*`), so a torchvision
`vgg16` state dict loads as it is.  The fc2 features follow the reference
wrapper: images in the caller's range, a nearest resize to 224 in torch's
legacy convention, no ImageNet renormalization, dropout the identity, fc2
taken before its ReLU.  The convolutions and the fc layers are cuDNN and
cuBLAS calls, as `rick_tpu` leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from rick_tpu_torch.metrics.resize import nearest_resize_torch

# config D: conv widths, "M" a 2x2 max pool
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]


def _conv_indices():
    """(index in torchvision's `features`, in, out) of each conv: a conv and
    its ReLU take two indices, a pool one."""
    idx, in_ch, out = 0, 3, []
    for c in _CFG:
        if c == "M":
            idx += 1
            continue
        out.append((idx, in_ch, c))
        in_ch = c
        idx += 2
    return out


_CONVS = _conv_indices()
PARAM_SHAPES = {
    **{f"features.{idx}.weight": (o, i, 3, 3) for idx, i, o in _CONVS},
    **{f"features.{idx}.bias": (o,) for idx, _i, o in _CONVS},
    "classifier.0.weight": (4096, 512 * 7 * 7),
    "classifier.0.bias": (4096,),
    "classifier.3.weight": (4096, 4096),
    "classifier.3.bias": (4096,),
}


def vgg16_init(seed: int = 1) -> Dict[str, torch.Tensor]:
    """Seeded weights of `rick_tpu`'s shapes and scales (He-normal convs,
    N(0, 0.01^2) fc layers, zero biases), drawn from a CPU `torch.Generator`.
    `rick_tpu` draws from `jax.random.key(seed)`, so the two packages'
    seeded VGGs differ; their features measure nothing about images."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    for idx, i, o in _CONVS:
        params[f"features.{idx}.weight"] = torch.randn((o, i, 3, 3), generator=gen) * math.sqrt(2.0 / (i * 9))
        params[f"features.{idx}.bias"] = torch.zeros(o)
    params["classifier.0.weight"] = torch.randn((4096, 512 * 7 * 7), generator=gen) * 0.01
    params["classifier.0.bias"] = torch.zeros(4096)
    params["classifier.3.weight"] = torch.randn((4096, 4096), generator=gen) * 0.01
    params["classifier.3.bias"] = torch.zeros(4096)
    return params


def load_vgg16_params(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision `vgg16` state dict (.pth) -> the flat params (f32); the
    last fc layer (`classifier.6`) is left out."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: sd[k].float() for k in PARAM_SHAPES}


def default_vgg16_params() -> Dict[str, torch.Tensor]:
    """The weights at `RICK_VGG16_WEIGHTS` when it is set (a missing file
    raises, where `rick_tpu` falls back to its seeded init), else
    `vgg16_init()`."""
    path = os.environ.get("RICK_VGG16_WEIGHTS", "")
    if not path:
        return vgg16_init()
    if not os.path.exists(path):
        raise FileNotFoundError(f"RICK_VGG16_WEIGHTS names {path!r}, which does not exist")
    return load_vgg16_params(path)


class VGG16(nn.Module):
    """torchvision's `vgg16` up to fc2: `features` holds the convs, ReLUs and
    pools at torchvision's indices, `classifier` fc1, its ReLU, the dropout
    (the identity in eval) and fc2.  Built uninitialized: load weights with
    `load_state_dict` or use `vgg16_from_params`."""

    def __init__(self):
        super().__init__()
        layers, convs = [], iter(_CONVS)
        for c in _CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
                continue
            _idx, i, o = next(convs)
            layers += [nn.utils.skip_init(nn.Conv2d, i, o, 3, padding=1), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.utils.skip_init(nn.Linear, 512 * 7 * 7, 4096), nn.ReLU(), nn.Identity(),
            nn.utils.skip_init(nn.Linear, 4096, 4096),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vgg16_fc2_features(self, x)


def vgg16_fc2_features(model: VGG16, x: torch.Tensor) -> torch.Tensor:
    """fc2 features (N, 4096), in the model's dtype, of NCHW images in the
    caller's range, resized (nearest, torch's legacy convention) to 224."""
    x = nearest_resize_torch(x.to(model.classifier[0].weight.dtype), 224, 224)
    return model.classifier(model.features(x).flatten(1))


def vgg16_from_params(params, *, device="cuda", dtype: torch.dtype = torch.float32) -> VGG16:
    """A `VGG16` in eval mode, without grads, on `device`, holding `params`
    (the flat torchvision-keyed dict, numpy arrays or tensors) cast to
    `dtype`."""
    model = VGG16()
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
          for k, v in params.items() if k in PARAM_SHAPES}
    model.load_state_dict(sd)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)
