"""InceptionV3 (torchvision architecture) to pool3, the FID feature extractor.
Port of `rick_tpu/metrics/inception.py`.

torchvision's `inception_v3` truncated after the final average pool (2048-d),
with the reference wrapper's input handling: bilinear resize to 299
(align_corners=False, no antialias) and the remap of [-1, 1] inputs to
ImageNet normalization.  Batch norm runs in its eval form (eps 1e-3).

Parameter and buffer names are the flat torchvision keys
(`Mixed_5b.branch1x1.conv.weight`, `....bn.running_var`, `fc.weight`), so a
torchvision `inception_v3` state dict loads with `load_state_dict(strict=False)`
(its AuxLogits and `num_batches_tracked` entries are not used).  The
architecture spec below is this package's own copy of the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rick_tpu_torch.metrics.resize import bilinear_resize_torch

# ---------------------------------------------------------------------------
# Architecture spec: name -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw))
# ---------------------------------------------------------------------------


def _conv(name, i, o, k, s=(1, 1), p=(0, 0)):
    if isinstance(k, int):
        k = (k, k)
    return (name, i, o, k, s, p)


def _inception_a(prefix, in_ch, pool_ch):
    return [
        _conv(f"{prefix}.branch1x1", in_ch, 64, 1),
        _conv(f"{prefix}.branch5x5_1", in_ch, 48, 1),
        _conv(f"{prefix}.branch5x5_2", 48, 64, 5, p=(2, 2)),
        _conv(f"{prefix}.branch3x3dbl_1", in_ch, 64, 1),
        _conv(f"{prefix}.branch3x3dbl_2", 64, 96, 3, p=(1, 1)),
        _conv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, p=(1, 1)),
        _conv(f"{prefix}.branch_pool", in_ch, pool_ch, 1),
    ]


def _inception_b(prefix, in_ch):
    return [
        _conv(f"{prefix}.branch3x3", in_ch, 384, 3, s=(2, 2)),
        _conv(f"{prefix}.branch3x3dbl_1", in_ch, 64, 1),
        _conv(f"{prefix}.branch3x3dbl_2", 64, 96, 3, p=(1, 1)),
        _conv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, s=(2, 2)),
    ]


def _inception_c(prefix, in_ch, c7):
    return [
        _conv(f"{prefix}.branch1x1", in_ch, 192, 1),
        _conv(f"{prefix}.branch7x7_1", in_ch, c7, 1),
        _conv(f"{prefix}.branch7x7_2", c7, c7, (1, 7), p=(0, 3)),
        _conv(f"{prefix}.branch7x7_3", c7, 192, (7, 1), p=(3, 0)),
        _conv(f"{prefix}.branch7x7dbl_1", in_ch, c7, 1),
        _conv(f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), p=(3, 0)),
        _conv(f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), p=(0, 3)),
        _conv(f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), p=(3, 0)),
        _conv(f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), p=(0, 3)),
        _conv(f"{prefix}.branch_pool", in_ch, 192, 1),
    ]


def _inception_d(prefix, in_ch):
    return [
        _conv(f"{prefix}.branch3x3_1", in_ch, 192, 1),
        _conv(f"{prefix}.branch3x3_2", 192, 320, 3, s=(2, 2)),
        _conv(f"{prefix}.branch7x7x3_1", in_ch, 192, 1),
        _conv(f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), p=(0, 3)),
        _conv(f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), p=(3, 0)),
        _conv(f"{prefix}.branch7x7x3_4", 192, 192, 3, s=(2, 2)),
    ]


def _inception_e(prefix, in_ch):
    return [
        _conv(f"{prefix}.branch1x1", in_ch, 320, 1),
        _conv(f"{prefix}.branch3x3_1", in_ch, 384, 1),
        _conv(f"{prefix}.branch3x3_2a", 384, 384, (1, 3), p=(0, 1)),
        _conv(f"{prefix}.branch3x3_2b", 384, 384, (3, 1), p=(1, 0)),
        _conv(f"{prefix}.branch3x3dbl_1", in_ch, 448, 1),
        _conv(f"{prefix}.branch3x3dbl_2", 448, 384, 3, p=(1, 1)),
        _conv(f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), p=(0, 1)),
        _conv(f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), p=(1, 0)),
        _conv(f"{prefix}.branch_pool", in_ch, 192, 1),
    ]


STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")
# (block, kind) in the trunk's order
BLOCKS = (
    ("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"), ("Mixed_6a", "b"), ("Mixed_6b", "c"),
    ("Mixed_6c", "c"), ("Mixed_6d", "c"), ("Mixed_6e", "c"), ("Mixed_7a", "d"), ("Mixed_7b", "e"),
    ("Mixed_7c", "e"),
)


def _all_convs():
    convs = [
        _conv("Conv2d_1a_3x3", 3, 32, 3, s=(2, 2)),
        _conv("Conv2d_2a_3x3", 32, 32, 3),
        _conv("Conv2d_2b_3x3", 32, 64, 3, p=(1, 1)),
        _conv("Conv2d_3b_1x1", 64, 80, 1),
        _conv("Conv2d_4a_3x3", 80, 192, 3),
    ]
    convs += _inception_a("Mixed_5b", 192, 32)
    convs += _inception_a("Mixed_5c", 256, 64)
    convs += _inception_a("Mixed_5d", 288, 64)
    convs += _inception_b("Mixed_6a", 288)
    for name, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)]:
        convs += _inception_c(name, 768, c7)
    convs += _inception_d("Mixed_7a", 768)
    convs += _inception_e("Mixed_7b", 1280)
    convs += _inception_e("Mixed_7c", 2048)
    return convs


_CONVS = _all_convs()
_SPEC = {name: (i, o, k, s, p) for name, i, o, k, s, p in _CONVS}
_SUFFIXES = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")
# every key of the module's state dict
PARAM_KEYS = tuple(f"{name}.{s}" for name in _SPEC for s in _SUFFIXES) + ("fc.weight", "fc.bias")


def inception_init_np(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded He-normal weights with identity batch-norm statistics, drawn
    with numpy (the same draws as `rick_tpu`'s `inception_init_np`, so both
    packages can be handed one dict)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {
        "fc.weight": (rng.standard_normal((1000, 2048)) * 0.02).astype(np.float32),
        "fc.bias": np.zeros((1000,), np.float32),
    }
    for name, i, o, k, s, p in _CONVS:
        fan_in = i * k[0] * k[1]
        params[f"{name}.conv.weight"] = (
            rng.standard_normal((o, i, k[0], k[1])) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        params[f"{name}.bn.weight"] = np.ones((o,), np.float32)
        params[f"{name}.bn.bias"] = np.zeros((o,), np.float32)
        params[f"{name}.bn.running_mean"] = np.zeros((o,), np.float32)
        params[f"{name}.bn.running_var"] = np.ones((o,), np.float32)
    return params


def randomize_bn(params, seed: int = 3) -> Dict[str, np.ndarray]:
    """A copy of the flat params with seeded non-trivial batch-norm
    statistics and affine (the seeded init's are identity), drawn with numpy
    as `tests/test_metrics_oracle.py` draws them."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k.endswith("bn.running_mean"):
            out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif k.endswith("bn.running_var"):
            out[k] = (0.5 + rng.random(v.shape) * 1.5).astype(np.float32)
        elif k.endswith("bn.weight"):
            out[k] = (0.7 + rng.random(v.shape)).astype(np.float32)
        elif k.endswith("bn.bias"):
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def load_inception_params(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision `inception_v3` state dict (.pth, optionally under a
    "state_dict" key) -> the flat params (f32); AuxLogits entries are left
    out, fc is kept where present."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: sd[k].float() for k in PARAM_KEYS if k in sd or not k.startswith("fc.")}


def default_inception_params():
    """The weights at `RICK_INCEPTION_WEIGHTS` when it is set (a missing file
    raises), else the seeded init `inception_init_np(0)`, whose features
    measure nothing about image quality."""
    path = os.environ.get("RICK_INCEPTION_WEIGHTS", "")
    if not path:
        return inception_init_np(0)
    if not os.path.exists(path):
        raise FileNotFoundError(f"RICK_INCEPTION_WEIGHTS names {path!r}, which does not exist")
    return load_inception_params(path)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _Conv(nn.Module):
    def __init__(self, i, o, k, s, p):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(o, i, *k))
        self.stride, self.padding = s, p

    def forward(self, x):
        return F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class _BatchNorm(nn.Module):
    """Batch norm in its eval form: the running statistics, eps 1e-3."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-3)


class BasicConv2d(nn.Module):
    """conv (no bias) -> batch norm -> ReLU."""

    def __init__(self, i, o, k, s, p):
        super().__init__()
        self.conv = _Conv(i, o, k, s, p)
        self.bn = _BatchNorm(o)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _maxpool(x):
    return F.max_pool2d(x, kernel_size=3, stride=2)


def _avgpool(x):
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=True)


class InceptionBlock(nn.Module):
    """One Mixed_* block; `kind` a..e is torchvision's InceptionA..E, whose
    branch order the concatenations keep."""

    def __init__(self, prefix: str, kind: str):
        super().__init__()
        self.kind = kind
        for name, (i, o, k, s, p) in _SPEC.items():
            if name.startswith(prefix + "."):
                setattr(self, name[len(prefix) + 1:], BasicConv2d(i, o, k, s, p))

    def forward(self, x):
        return getattr(self, f"_forward_{self.kind}")(x)

    def _forward_a(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool(x))
        return torch.cat([b1, b5, b3, bp], 1)

    def _forward_b(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool(x)], 1)

    def _forward_c(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _forward_d(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool(x)], 1)

    def _forward_e(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avgpool(x))
        return torch.cat([b1, b3, bd, bp], 1)


# the ImageNet remap of [-1, 1] inputs, per channel
_REMAP_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_REMAP_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)


class InceptionV3(nn.Module):
    """The torchvision trunk to pool3, plus fc for the logits.  Built with
    zero weights: load them with `load_state_dict` or use
    `inception_from_params`."""

    def __init__(self):
        super().__init__()
        for name in STEM:
            setattr(self, name, BasicConv2d(*_SPEC[name]))
        for name, kind in BLOCKS:
            setattr(self, name, InceptionBlock(name, kind))
        self.fc = nn.utils.skip_init(nn.Linear, 2048, 1000)  # no draw from the global RNG
        nn.init.zeros_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)
        self.channels_last = False

    def _stages(self):
        yield "Conv2d_1a_3x3", self.Conv2d_1a_3x3
        yield "Conv2d_2a_3x3", self.Conv2d_2a_3x3
        yield "Conv2d_2b_3x3", lambda x: _maxpool(self.Conv2d_2b_3x3(x))
        yield "Conv2d_3b_1x1", self.Conv2d_3b_1x1
        yield "Conv2d_4a_3x3", lambda x: _maxpool(self.Conv2d_4a_3x3(x))
        for name, _ in BLOCKS:
            yield name, getattr(self, name)

    def pool3(
        self, x: torch.Tensor, *, resize_input: bool = True, normalize_input: bool = True,
        stop_at: Optional[str] = None, resize_to: int = 299,
    ) -> torch.Tensor:
        """pool3 activations (N, 2048), in the module's dtype, of NCHW images
        in [-1, 1]: bilinear resize to `resize_to`, the ImageNet remap, the
        trunk, the spatial mean.  `stop_at` pools right after the named
        stage (a smaller trunk of the same structure, for cheap tests, as in
        JAX; metric values use the whole trunk at 299)."""
        x = x.to(self.fc.weight.dtype)
        if resize_input:
            x = bilinear_resize_torch(x, resize_to, resize_to)
        if normalize_input:
            scale = torch.tensor(_REMAP_SCALE, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
            shift = torch.tensor(_REMAP_SHIFT, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
            x = x * scale + shift
        if self.channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        for name, stage in self._stages():
            x = stage(x)
            if name == stop_at:
                break
        return x.mean(dim=(2, 3))

    forward = pool3

    def logits(self, x: torch.Tensor, *, resize_input: bool = True) -> torch.Tensor:
        """1000-way logits, for the Inception Score: generator-range images
        with no ImageNet remap, as the reference feeds them."""
        return self.fc(self.pool3(x, resize_input=resize_input, normalize_input=False))


def inception_from_params(
    params, *, device="cuda", dtype: torch.dtype = torch.float32, channels_last: bool = False,
) -> InceptionV3:
    """An `InceptionV3` in eval mode, without grads, on `device` holding `params` (the flat
    torchvision-keyed dict, numpy arrays or tensors; fc may be absent), cast
    to `dtype`, its convolutions in `channels_last` layout if asked."""
    model = InceptionV3()
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v, np.float32))
          for k, v in params.items() if k in PARAM_KEYS}
    missing = [k for k in model.load_state_dict(sd, strict=False).missing_keys if not k.startswith("fc.")]
    if missing:
        raise KeyError(f"inception params lack {missing[:5]}")
    model = model.to(device=device, dtype=dtype).eval().requires_grad_(False)
    if channels_last:
        model = model.to(memory_format=torch.channels_last)
        model.channels_last = True
    return model
