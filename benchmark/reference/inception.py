"""Plain InceptionV3 to pool3, the FID feature extractor, in PyTorch: the
yardstick for the evaluator's activations.

torchvision's `inception_v3` trunk cut after the final average pool, with
pytorch-fid's input handling: bilinear resize to 299 (align_corners=False,
no antialias) and the remap of [-1, 1] images to ImageNet normalization;
batch norm in its eval form, eps 1e-3.  Weight names are torchvision's flat
keys (`Mixed_5b.branch1x1.conv.weight`, `....bn.running_var`).  It imports
nothing of the program; the weights are handed to it as a dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _c(name, i, o, k, s=1, p=0):
    k = (k, k) if isinstance(k, int) else k
    s = (s, s) if isinstance(s, int) else s
    p = (p, p) if isinstance(p, int) else p
    return name, i, o, k, s, p


def _block_a(n, i, pool):
    return [_c(f"{n}.branch1x1", i, 64, 1), _c(f"{n}.branch5x5_1", i, 48, 1), _c(f"{n}.branch5x5_2", 48, 64, 5, p=2),
            _c(f"{n}.branch3x3dbl_1", i, 64, 1), _c(f"{n}.branch3x3dbl_2", 64, 96, 3, p=1),
            _c(f"{n}.branch3x3dbl_3", 96, 96, 3, p=1), _c(f"{n}.branch_pool", i, pool, 1)]


def _block_b(n, i):
    return [_c(f"{n}.branch3x3", i, 384, 3, s=2), _c(f"{n}.branch3x3dbl_1", i, 64, 1),
            _c(f"{n}.branch3x3dbl_2", 64, 96, 3, p=1), _c(f"{n}.branch3x3dbl_3", 96, 96, 3, s=2)]


def _block_c(n, i, c7):
    return [_c(f"{n}.branch1x1", i, 192, 1), _c(f"{n}.branch7x7_1", i, c7, 1),
            _c(f"{n}.branch7x7_2", c7, c7, (1, 7), p=(0, 3)), _c(f"{n}.branch7x7_3", c7, 192, (7, 1), p=(3, 0)),
            _c(f"{n}.branch7x7dbl_1", i, c7, 1), _c(f"{n}.branch7x7dbl_2", c7, c7, (7, 1), p=(3, 0)),
            _c(f"{n}.branch7x7dbl_3", c7, c7, (1, 7), p=(0, 3)), _c(f"{n}.branch7x7dbl_4", c7, c7, (7, 1), p=(3, 0)),
            _c(f"{n}.branch7x7dbl_5", c7, 192, (1, 7), p=(0, 3)), _c(f"{n}.branch_pool", i, 192, 1)]


def _block_d(n, i):
    return [_c(f"{n}.branch3x3_1", i, 192, 1), _c(f"{n}.branch3x3_2", 192, 320, 3, s=2),
            _c(f"{n}.branch7x7x3_1", i, 192, 1), _c(f"{n}.branch7x7x3_2", 192, 192, (1, 7), p=(0, 3)),
            _c(f"{n}.branch7x7x3_3", 192, 192, (7, 1), p=(3, 0)), _c(f"{n}.branch7x7x3_4", 192, 192, 3, s=2)]


def _block_e(n, i):
    return [_c(f"{n}.branch1x1", i, 320, 1), _c(f"{n}.branch3x3_1", i, 384, 1),
            _c(f"{n}.branch3x3_2a", 384, 384, (1, 3), p=(0, 1)), _c(f"{n}.branch3x3_2b", 384, 384, (3, 1), p=(1, 0)),
            _c(f"{n}.branch3x3dbl_1", i, 448, 1), _c(f"{n}.branch3x3dbl_2", 448, 384, 3, p=1),
            _c(f"{n}.branch3x3dbl_3a", 384, 384, (1, 3), p=(0, 1)),
            _c(f"{n}.branch3x3dbl_3b", 384, 384, (3, 1), p=(1, 0)), _c(f"{n}.branch_pool", i, 192, 1)]


CONVS = ([_c("Conv2d_1a_3x3", 3, 32, 3, s=2), _c("Conv2d_2a_3x3", 32, 32, 3), _c("Conv2d_2b_3x3", 32, 64, 3, p=1),
          _c("Conv2d_3b_1x1", 64, 80, 1), _c("Conv2d_4a_3x3", 80, 192, 3)]
         + _block_a("Mixed_5b", 192, 32) + _block_a("Mixed_5c", 256, 64) + _block_a("Mixed_5d", 288, 64)
         + _block_b("Mixed_6a", 288)
         + [c for n, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192))
            for c in _block_c(n, 768, c7)]
         + _block_d("Mixed_7a", 768) + _block_e("Mixed_7b", 1280) + _block_e("Mixed_7c", 2048))
SPEC = {name: (i, o, k, s, p) for name, i, o, k, s, p in CONVS}
BLOCKS = (("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"), ("Mixed_6a", "b"), ("Mixed_6b", "c"),
          ("Mixed_6c", "c"), ("Mixed_6d", "c"), ("Mixed_6e", "c"), ("Mixed_7a", "d"), ("Mixed_7b", "e"),
          ("Mixed_7c", "e"))
_REMAP_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_REMAP_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)


def leaves():
    """[(name, shape, scale, shift)] of every weight: He-normal convolutions
    (randn * sqrt(2 / fan_in)) and identity batch norms, drawn as randn *
    scale + shift (scale 0: a constant)."""
    out = []
    for name, i, o, k, s, p in CONVS:
        out.append((f"{name}.conv.weight", (o, i, *k), (2.0 / (i * k[0] * k[1])) ** 0.5, 0.0))
        out += [(f"{name}.bn.weight", (o,), 0.0, 1.0), (f"{name}.bn.bias", (o,), 0.0, 0.0),
                (f"{name}.bn.running_mean", (o,), 0.0, 0.0), (f"{name}.bn.running_var", (o,), 0.0, 1.0)]
    return out


class InceptionPool3:
    """pool3 (N, 2048) of NCHW images in [-1, 1], with the weights `params`."""

    def __init__(self, params: Dict[str, torch.Tensor], stop_at: Optional[str] = None, resize_to: int = 299):
        """`stop_at` pools right after the named stage, and `resize_to`
        replaces 299: a smaller trunk of the same structure, for tests."""
        self.p, self.stop_at, self.size = params, stop_at, resize_to

    def _basic(self, name, x):
        i, o, k, s, pad = SPEC[name]
        x = F.conv2d(x, self.p[f"{name}.conv.weight"], stride=s, padding=pad)
        x = F.batch_norm(x, self.p[f"{name}.bn.running_mean"], self.p[f"{name}.bn.running_var"],
                         self.p[f"{name}.bn.weight"], self.p[f"{name}.bn.bias"], training=False, eps=1e-3)
        return F.relu(x)

    def _chain(self, prefix, names, x):
        for n in names:
            x = self._basic(f"{prefix}.{n}", x)
        return x

    def _block(self, n, kind, x):
        c = lambda names, y=x: self._chain(n, names, y)  # noqa: E731
        pool = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)
        if kind == "a":
            parts = [c(["branch1x1"]), c(["branch5x5_1", "branch5x5_2"]),
                     c(["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]), c(["branch_pool"], pool)]
        elif kind == "b":
            parts = [c(["branch3x3"]), c(["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]),
                     F.max_pool2d(x, 3, stride=2)]
        elif kind == "c":
            parts = [c(["branch1x1"]), c(["branch7x7_1", "branch7x7_2", "branch7x7_3"]),
                     c([f"branch7x7dbl_{j}" for j in range(1, 6)]), c(["branch_pool"], pool)]
        elif kind == "d":
            parts = [c(["branch3x3_1", "branch3x3_2"]), c([f"branch7x7x3_{j}" for j in range(1, 5)]),
                     F.max_pool2d(x, 3, stride=2)]
        else:
            b3 = c(["branch3x3_1"])
            bd = c(["branch3x3dbl_1", "branch3x3dbl_2"])
            parts = [c(["branch1x1"]),
                     torch.cat([self._basic(f"{n}.branch3x3_2a", b3), self._basic(f"{n}.branch3x3_2b", b3)], 1),
                     torch.cat([self._basic(f"{n}.branch3x3dbl_3a", bd), self._basic(f"{n}.branch3x3dbl_3b", bd)], 1),
                     c(["branch_pool"], pool)]
        return torch.cat(parts, 1)

    def _stages(self):
        yield "Conv2d_1a_3x3", lambda x: self._basic("Conv2d_1a_3x3", x)
        yield "Conv2d_2a_3x3", lambda x: self._basic("Conv2d_2a_3x3", x)
        yield "Conv2d_2b_3x3", lambda x: F.max_pool2d(self._basic("Conv2d_2b_3x3", x), 3, stride=2)
        yield "Conv2d_3b_1x1", lambda x: self._basic("Conv2d_3b_1x1", x)
        yield "Conv2d_4a_3x3", lambda x: F.max_pool2d(self._basic("Conv2d_4a_3x3", x), 3, stride=2)
        for n, kind in BLOCKS:
            yield n, lambda x, n=n, kind=kind: self._block(n, kind, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2:] != (self.size, self.size):
            x = F.interpolate(x, size=(self.size, self.size), mode="bilinear", align_corners=False, antialias=False)
        scale = torch.tensor(_REMAP_SCALE, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
        shift = torch.tensor(_REMAP_SHIFT, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
        x = x * scale + shift
        for name, stage in self._stages():
            x = stage(x)
            if name == self.stop_at:
                break
        return x.mean(dim=(2, 3))
