"""Plain StyleGAN2 generator and discriminator in PyTorch, the yardstick the
benchmark holds the port's G and D to.

The architecture is rosinality's `stylegan2-pytorch` (`model.py`) with the
modulated convolution written as demod * conv(x * style, w), which equals
the grouped convolution because the convolution is linear in both scalings.
Parameter and buffer names are rosinality's, so one state dict loads into
this model and into the program's.  Every layer is plain torch: no fused
kernel, no cache, no batching beyond the batch given.  It imports nothing of
the program; it is a frozen copy of the arithmetic of the program's plain
versions, so a later change to the program cannot move it.

Departures from rosinality, each also the program's: the minibatch-stddev
group is min(batch, `stddev_group`) with `stddev_group` 25 (RICK's D), and
the discriminator returns its feature taps beside the score.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)


def channel_table(channel_multiplier: int) -> dict:
    cm = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm, 256: 64 * cm, 512: 32 * cm,
            1024: 16 * cm}


def lrelu(v: torch.Tensor, slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    return torch.where(v >= 0, v, v * slope) * scale


def bias_lrelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """leaky_relu(x + bias) * sqrt(2), bias on dim 1 (the last dim of a 2-D x)."""
    shape = (1, -1) if x.ndim == 2 else (1, -1) + (1,) * (x.ndim - 2)
    return lrelu(x + bias.reshape(shape))


# ---------------------------------------------------------------------------
# upfirdn2d.  Its FIR convolution is a Function whose derivatives are again
# convolutions of the same shape: PyTorch's own double backward of a
# convolution also computes the second-derivative term of a filter that needs
# no gradient, a convolution with the first gradient as a filter as large as
# the image, which is no part of the model's arithmetic.
# ---------------------------------------------------------------------------


def _data_grad_padding(transpose: bool, x_shape, y_shape, w_shape, stride) -> tuple:
    if transpose:
        return (0, 0)
    return tuple(x_shape[i + 2] - (y_shape[i + 2] - 1) * stride[i] - w_shape[i + 2] for i in range(2))


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, transpose: bool, stride, output_padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (transpose, stride, output_padding)
        if transpose:
            return F.conv_transpose2d(x, w, stride=stride, output_padding=output_padding)
        return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        transpose, stride, _ = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _Conv.apply(gy, w, not transpose, stride,
                             _data_grad_padding(transpose, x.shape, gy.shape, w.shape, stride))
        if ctx.needs_input_grad[1]:
            gw = _ConvGradWeight.apply(gy, x, w, *ctx.conf)
        return gx, gw, None, None, None


class _ConvGradWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gy, x, w, transpose: bool, stride, output_padding):
        ctx.save_for_backward(gy, x)
        ctx.conf = (transpose, stride, output_padding)
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, stride, (0, 0), (1, 1), transpose, output_padding, 1, [False, True, False])[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        transpose, stride, _ = ctx.conf
        g_gy = g_x = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(x, ggw, *ctx.conf)
        if ctx.needs_input_grad[1]:
            g_x = _Conv.apply(gy, ggw, not transpose, stride,
                              _data_grad_padding(transpose, x.shape, gy.shape, ggw.shape, stride))
        return g_gy, g_x, None, None, None, None


def make_kernel(k: Sequence[float], device=None) -> torch.Tensor:
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Zero-insertion upsample by `up`, pad by `pad` on both axes (negative:
    crop), true 2-D convolution with `kernel`, stride-downsample by `down`."""
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    p0, p1 = pad
    out_h = (h * up + p0 + p1 - kh) // down + 1
    out_w = (w * up + p0 + p1 - kw) // down + 1
    out = x.reshape(n * c, h, 1, w, 1)
    out = F.pad(out, [0, up - 1, 0, 0, 0, up - 1]).reshape(n * c, 1, h * up, w * up)
    out = F.pad(out, [max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)])
    out = out[:, :, max(-p0, 0): out.shape[2] - max(-p1, 0), max(-p0, 0): out.shape[3] - max(-p1, 0)]
    out = _Conv.apply(out, torch.flip(kernel, (0, 1)).to(out.dtype)[None, None], False, (down, down), (0, 0))
    return out.reshape(n, c, out_h, out_w)


# ---------------------------------------------------------------------------
# Blocks, with rosinality's names
# ---------------------------------------------------------------------------


class Blur(nn.Module):
    def __init__(self, kernel, pad, upsample_factor: int = 1):
        super().__init__()
        self.register_buffer("kernel", make_kernel(kernel) * upsample_factor ** 2, persistent=False)
        self.pad = tuple(pad)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    def __init__(self, kernel, factor: int = 2):
        super().__init__()
        self.register_buffer("kernel", make_kernel(kernel) * factor ** 2, persistent=False)
        self.factor = factor
        p = self.kernel.shape[0] - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, up=self.factor, pad=self.pad)


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, *, lr_mul: float = 1.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation:
            return bias_lrelu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, k, *, stride=1, padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias, stride=self.stride, padding=self.padding)


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, k, style_dim, *, demodulate=True, upsample=False, downsample=False,
                 blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, out_ch, in_ch, k, k))
        self.modulation = EqualLinear(style_dim, in_ch)
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.k, self.demodulate, self.upsample, self.downsample = k, demodulate, upsample, downsample
        if upsample:
            p = (len(blur_kernel) - 2) - (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + 1, p // 2 + 1), 2)
        elif downsample:
            p = (len(blur_kernel) - 2) + (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2, p // 2))

    def forward(self, x, style):
        s = self.modulation(style)
        w = self.weight[0] * self.scale
        xs = x * s[:, :, None, None]
        if self.upsample:
            out = F.conv_transpose2d(xs, w.transpose(0, 1), stride=2)
        elif self.downsample:
            out = F.conv2d(self.blur(xs), w, stride=2)
        else:
            out = F.conv2d(xs, w, padding=self.k // 2)
        if self.demodulate:
            demod = torch.rsqrt((s * s) @ (w * w).sum(dim=(2, 3)).t() + 1e-8)
            out = out * demod[:, :, None, None]
        if self.upsample:
            out = self.blur(out)
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def forward(self, image, noise):
        return image + self.weight * noise


class FusedLeakyReLU(nn.Module):
    def __init__(self, channel):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(channel))

    def forward(self, x):
        return bias_lrelu(x, self.bias)


class ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return lrelu(x)


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, k, style_dim, *, upsample=False, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, k, style_dim, upsample=upsample, blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    def __init__(self, in_ch, style_dim, *, upsample=True, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        return out if skip is None else out + self.upsample(skip)


class ConvLayer(nn.Sequential):
    def __init__(self, in_ch, out_ch, k, *, downsample=False, blur_kernel=(1, 3, 3, 1), bias=True, activate=True):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (k - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, k // 2
        layers.append(EqualConv2d(in_ch, out_ch, k, stride=stride, padding=padding, bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_ch) if bias else ScaledLeakyReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(self, in_ch, out_ch, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, blur_kernel=blur_kernel)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False, bias=False, blur_kernel=blur_kernel)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / SQRT2


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


class Generator(nn.Module):
    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2, blur_kernel=(1, 3, 3, 1), lr_mlp=0.01):
        super().__init__()
        ch = channel_table(channel_multiplier)
        self.size, self.style_dim = size, style_dim
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        self.style = nn.Sequential(nn.Identity(), *[EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation=True)
                                                    for _ in range(n_mlp)])
        self.input = nn.Module()
        self.input.input = nn.Parameter(torch.empty(1, ch[4], 4, 4))
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim, blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim, upsample=True, blur_kernel=blur_kernel))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim, blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, blur_kernel=blur_kernel))
            in_ch = out_ch
        self.noises = nn.Module()
        for j in range(self.num_layers):
            r = self.noise_res(j)
            self.noises.register_buffer(f"noise_{j}", torch.empty(1, 1, r, r))

    @staticmethod
    def noise_res(j: int) -> int:
        return 2 ** ((j + 5) // 2)

    def mapping(self, z):
        z = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        return self.style(z)

    def make_latent(self, z1, z2=None, inject_index=None):
        """(B, n_latent, style_dim): layers >= inject_index take z2's style."""
        w1 = self.mapping(z1)
        if z2 is None:
            return w1[:, None, :].repeat(1, self.n_latent, 1)
        w2 = self.mapping(z2)
        layer = torch.arange(self.n_latent, device=w1.device)[None, :, None]
        inject = torch.as_tensor(inject_index, device=w1.device).reshape(-1, 1, 1)
        return torch.where(layer < inject, w1[:, None, :], w2[:, None, :])

    def synthesis(self, latent, noise: List[torch.Tensor]):
        out = self.input.input.repeat(latent.shape[0], 1, 1, 1)
        out = self.conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for b, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * b](out, latent[:, i], noise[2 * b + 1])
            out = self.convs[2 * b + 1](out, latent[:, i + 1], noise[2 * b + 2])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip

    def forward(self, z, noise):
        return self.synthesis(self.make_latent(z), noise)


def minibatch_stddev(x, group: int = 25):
    b, c, h, w = x.shape
    g = min(b, group)
    y = x.reshape(g, b // g, 1, c, h, w)
    std = torch.sqrt(torch.var(y, dim=0, unbiased=False) + 1e-8).mean(dim=(2, 3, 4))  # (b//g, 1)
    std = std[None, :, :, None, None].expand(g, b // g, 1, h, w).reshape(b, 1, h, w)
    return torch.cat([x, std], dim=1)


class Discriminator(nn.Module):
    def __init__(self, size, channel_multiplier=2, blur_kernel=(1, 3, 3, 1), stddev_group=25):
        super().__init__()
        ch = channel_table(channel_multiplier)
        self.stddev_group = stddev_group
        self.convs = nn.ModuleList([ConvLayer(3, ch[size], 1)])
        in_ch = ch[size]
        for i in range(int(math.log2(size)), 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.convs.append(ResBlock(in_ch, out_ch, blur_kernel))
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3)
        self.final_linear = nn.Sequential(EqualLinear(ch[4] * 16, ch[4], activation=True), EqualLinear(ch[4], 1))

    def forward(self, x):
        out = x
        for block in self.convs:
            out = block(out)
        out = self.final_conv(minibatch_stddev(out, self.stddev_group))
        return self.final_linear(out.reshape(out.shape[0], -1))


def models(cfg: dict, device="cpu"):
    """(G, D) of a configuration file's sizes on `device`, with empty weights."""
    bk = tuple(cfg["blur_kernel"])
    with torch.device(device):
        g = Generator(cfg["size"], cfg["style_dim"], cfg["n_mlp"], cfg["channel_multiplier"], bk, cfg["lr_mlp"])
        d = Discriminator(cfg["d_size"], cfg["d_channel_multiplier"], bk, cfg["stddev_group"])
    return g, d


def init_rule(name: str, cfg: dict) -> tuple:
    """(scale, shift) of a leaf's draw, randn * scale + shift: rosinality's
    init (randn weights, mapping weights / lr_mlp, modulation bias 1), with
    small random biases and noise weights in place of its zeros, so that
    every bias and noise path carries a value."""
    if name.startswith("noises."):
        return 1.0, 0.0
    if name.endswith("modulation.bias"):
        return 0.1, 1.0
    if name.startswith("style.") and name.endswith(".weight"):
        return 1.0 / cfg["lr_mlp"], 0.0
    if name.endswith("bias") or name.endswith("noise.weight"):
        return 0.1, 0.0
    return 1.0, 0.0
