"""StyleGAN2 building blocks as `nn.Module`s.  Port of `rick_tpu/nn/blocks.py`.

Parameter names and shapes are rosinality's, so `state_dict()` keys are the
checkpoint keys (`rick_tpu/ckpt/convert.py:3-23`): the modulated conv weight
is 5-D (1, out, in, k, k), the noise weight has shape (1,).  FIR kernels are
non-persistent buffers, so they follow `.to(device)` without entering the
state dict.

Every constructor that draws weights takes `rng`, a `torch.Generator` on the
module's `device`: no global RNG state is used.

Compute dtype: parameters stay f32, and each block casts them to its
input's dtype where rick_tpu's blocks cast (`astype(x.dtype)`), so a bf16
input runs the layer in bf16 exactly as rick_tpu's does.  A Python scalar
applied to a bf16 tensor is first rounded to bf16 (`weak_scalar`), as JAX
applies a weakly typed scalar; every cast is written out, since torch's
promotion differs from JAX's (a (1,)-shaped f32 times a bf16 tensor is f32
in torch, and a 0-d f32 times a bf16 tensor is bf16).  The activations'
biases stay f32, so the first biased activation after a bf16 layer gives
f32, as JAX promotes bf16 + f32.

`StyledConv` runs through the fused kernels: the upsample branch through
`convt_blur_act` when the caller asks for it (`fast=True`, forward only, as
in JAX), else through the differentiable chain; the other branch (with
noise) through `modconv_epilogue`; every activation elsewhere through
`fused_bias_act`.  Each kernel wrapper takes its plain version on a CPU
tensor.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rick_tpu_torch.dist import all_gather_rows, process_batch_slice
from rick_tpu_torch.ops import (
    convt_blur_act,
    fused_leaky_relu,
    make_kernel,
    modconv_epilogue,
    scaled_leaky_relu,
    upfirdn2d,
)


def _randn(shape, rng: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=rng, device=device)


@functools.lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """`value` as JAX applies a Python scalar to an array of `dtype`: rounded
    to that dtype first (for f32, what torch does with the scalar too)."""
    return float(torch.tensor(value, dtype=dtype))


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """Normalize over dim 1."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class Blur(nn.Module):
    """FIR blur (upfirdn2d with pad), gain upsample_factor**2."""

    def __init__(self, kernel: Sequence[int], pad, upsample_factor: int = 1, *, device=None):
        super().__init__()
        k = make_kernel(kernel, device) * (upsample_factor**2)
        self.register_buffer("kernel", k, persistent=False)
        self.pad = tuple(pad)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    """Antialiased 2x upsample of the ToRGB skip."""

    def __init__(self, kernel: Sequence[int], factor: int = 2, *, device=None):
        super().__init__()
        k = make_kernel(kernel, device) * (factor**2)
        self.register_buffer("kernel", k, persistent=False)
        self.factor = factor
        p = k.shape[0] - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, up=self.factor, down=1, pad=self.pad)


class EqualLinear(nn.Module):
    def __init__(
        self, in_dim: int, out_dim: int, *, bias_init: float = 0.0, lr_mul: float = 1.0,
        activation: Optional[str] = None, rng: torch.Generator, device=None,
    ):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_dim, in_dim), rng, device) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init), device=device))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        w = self.weight.to(x.dtype) * weak_scalar(self.scale, x.dtype)
        b = self.bias.to(x.dtype) * weak_scalar(self.lr_mul, x.dtype)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(F.linear(x, w), b)
        return F.linear(x, w, b)


class EqualConv2d(nn.Module):
    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, *, stride: int = 1, padding: int = 0,
        bias: bool = True, rng: torch.Generator, device=None,
    ):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_ch, in_ch, kernel_size, kernel_size), rng, device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        w = self.weight.to(x.dtype) * weak_scalar(self.scale, x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, stride=self.stride, padding=self.padding)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv via the scale-input / demod-output identity:

        y = demod[b,o] * conv(x * style[b,i], scale * w)
        demod[b,o] = rsqrt(sum_i style[b,i]^2 * scale^2 * sum_kk w[o,i]^2 + 1e-8)

    one batch-shared weight instead of rosinality's per-sample grouped conv;
    equal because the conv is linear in both scalings."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, style_dim: int, *,
        demodulate: bool = True, upsample: bool = False, downsample: bool = False,
        blur_kernel: Sequence[int] = (1, 3, 3, 1), rng: torch.Generator, device=None,
    ):
        super().__init__()
        self.weight = nn.Parameter(_randn((1, out_ch, in_ch, kernel_size, kernel_size), rng, device))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0, rng=rng, device=device)
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample
        self.blur_kernel = tuple(blur_kernel)
        if upsample:
            p = (len(blur_kernel) - 2) - (kernel_size - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + 1, p // 2 + 1), 2, device=device)
        elif downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2, p // 2), device=device)

    def modulate(self, x, style):
        """(x * style, scaled 4-D weight, demod (B, out) or None), in x's
        dtype; the demod sums in f32."""
        s = self.modulation(style)  # (B, in)
        weight = self.weight[0].to(x.dtype) * weak_scalar(self.scale, x.dtype)
        demod = None
        if self.demodulate:
            w2 = (weight * weight).float().sum(dim=(2, 3))  # (out, in)
            demod = torch.rsqrt((s * s).float() @ w2.t() + 1e-8).to(x.dtype)
        return x * s[:, :, None, None].to(x.dtype), weight, demod

    def forward(self, x, style, *, defer_demod: bool = False):
        """`defer_demod=True` (plain branch only) returns (out, demod) for a
        caller that folds demod into its epilogue."""
        xs, weight, demod = self.modulate(x, style)
        if self.upsample:
            out = F.conv_transpose2d(xs, weight.transpose(0, 1), stride=2)
            if demod is not None:
                out = out * demod[:, :, None, None]
            return self.blur(out)
        if self.downsample:
            out = F.conv2d(self.blur(xs), weight, stride=2)
        else:
            out = F.conv2d(xs, weight, padding=self.kernel_size // 2)
            if defer_demod:
                return out, demod
        if demod is not None:
            out = out * demod[:, :, None, None]
        return out


class NoiseInjection(nn.Module):
    def __init__(self, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, image, noise=None):
        if noise is None:
            return image
        return image + self.weight.to(image.dtype) * noise.to(image.dtype)


class ConstantInput(nn.Module):
    def __init__(self, channel: int, size: int = 4, *, rng: torch.Generator, device=None):
        super().__init__()
        self.input = nn.Parameter(_randn((1, channel, size, size), rng, device))

    def forward(self, batch: int, dtype: torch.dtype = torch.float32):
        return self.input.to(dtype).repeat(batch, 1, 1, 1)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channel: int, *, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel, device=device))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x)


class StyledConv(nn.Module):
    """ModulatedConv2d + NoiseInjection + FusedLeakyReLU.  `noise` is
    (B|1, 1, H', W') at the output resolution, or None.

    `fast=True` sends the upsample branch through `convt_blur_act` (K4,
    forward only: for generation); `fast=False`, the default as in JAX, takes
    the training chain conv_transpose2d -> demod -> blur -> noise ->
    FusedLeakyReLU.  The branch without upsample and with noise takes
    `modconv_epilogue` either way."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, style_dim: int, *,
        upsample: bool = False, blur_kernel: Sequence[int] = (1, 3, 3, 1),
        rng: torch.Generator, device=None,
    ):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_ch, out_ch, kernel_size, style_dim, upsample=upsample,
            blur_kernel=blur_kernel, rng=rng, device=device,
        )
        self.noise = NoiseInjection(device=device)
        self.activate = FusedLeakyReLU(out_ch, device=device)

    def forward(self, x, style, noise=None, *, fast: bool = False):
        if fast and self.conv.upsample:
            xs, weight, demod = self.conv.modulate(x, style)
            h2, w2 = 2 * x.shape[2], 2 * x.shape[3]
            if noise is None:
                noise_s = torch.zeros((1, 1, h2, w2), device=x.device)
            else:
                noise_s = (noise * self.noise.weight).contiguous()
            return convt_blur_act(
                xs, weight, demod, noise_s, self.activate.bias,
                blur_kernel=self.conv.blur_kernel,
            )
        if not self.conv.upsample and noise is not None:
            out, demod = self.conv(x, style, defer_demod=True)
            return modconv_epilogue(out, demod, noise.to(out.dtype), self.noise.weight.to(out.dtype),
                                    self.activate.bias)
        out = self.conv(x, style)
        out = self.noise(out, noise)
        return self.activate(out)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) + bias, plus the 2x-upsampled skip."""

    def __init__(
        self, in_ch: int, style_dim: int, *, upsample: bool = True,
        blur_kernel: Sequence[int] = (1, 3, 3, 1), rng: torch.Generator, device=None,
    ):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel, device=device)
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False, rng=rng, device=device)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1, device=device))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class ConvLayer(nn.Sequential):
    """[Blur] + EqualConv2d + [activation], as a Sequential so that the state
    dict keys are rosinality's (`convs.{b}.conv2.1.weight`, `...conv2.2.bias`)."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, *, downsample: bool = False,
        blur_kernel: Sequence[int] = (1, 3, 3, 1), bias: bool = True, activate: bool = True,
        rng: torch.Generator, device=None,
    ):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2), device=device))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(
            in_ch, out_ch, kernel_size, stride=stride, padding=padding,
            bias=bias and not activate, rng=rng, device=device,
        ))
        if activate:
            layers.append(FusedLeakyReLU(out_ch, device=device) if bias else ScaledLeakyReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(
        self, in_ch: int, out_ch: int, *, blur_kernel: Sequence[int] = (1, 3, 3, 1),
        rng: torch.Generator, device=None,
    ):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, blur_kernel=blur_kernel, rng=rng, device=device)
        self.conv2 = ConvLayer(
            in_ch, out_ch, 3, downsample=True, blur_kernel=blur_kernel, rng=rng, device=device,
        )
        self.skip = ConvLayer(
            in_ch, out_ch, 1, downsample=True, activate=False, bias=False,
            blur_kernel=blur_kernel, rng=rng, device=device,
        )

    def forward(self, x):
        """Returns (out, conv1 feature, conv2 feature)."""
        f1 = self.conv1(x)
        f2 = self.conv2(f1)
        return (f2 + self.skip(x)) / math.sqrt(2.0), f1, f2


def minibatch_stddev(x, *, stddev_group: int = 25, stddev_feat: int = 1, splits: int = 1, group=None):
    """Minibatch stddev with group min(batch, 25), population variance.

    `splits=s` treats the batch as `s` contiguous sub-batches, each with its
    own statistics (equal to `s` separate calls).  With a process `group`,
    x is this rank's rows of a global batch: the statistics are those of
    the global batch, gathered differentiably (`dist.all_gather_rows`), and
    this rank's rows of the result come back, as one process computes them
    on the whole batch.  The two do not combine: the gathered batch is
    rank-major, not split-major."""
    if group is not None:
        if splits != 1:
            raise ValueError(f"splits={splits} with a process group: the gathered batch is not split-major")
        xg = all_gather_rows(x, group)
        out = minibatch_stddev(xg, stddev_group=stddev_group, stddev_feat=stddev_feat, splits=splits)
        start, size = process_batch_slice(xg.shape[0], group)
        return out[start : start + size]
    batch, channel, height, width = x.shape
    if batch % splits:
        raise ValueError(f"batch {batch} does not split into {splits}")
    b = batch // splits
    gsize = min(b, stddev_group)
    y = x.reshape(splits, gsize, b // gsize, stddev_feat, channel // stddev_feat, height, width)
    var = torch.var(y, dim=1, unbiased=False)  # (s, b//group, feat, C//feat, H, W)
    stddev = torch.sqrt(var + 1e-8).mean(dim=(3, 4, 5))  # (s, b//group, feat)
    stddev = stddev[:, None, :, :, None, None].expand(splits, gsize, b // gsize, stddev_feat, height, width)
    stddev = stddev.reshape(batch, stddev_feat, height, width)
    return torch.cat([x, stddev.to(x.dtype)], dim=1)
