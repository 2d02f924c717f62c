"""StyleGAN2 Generator.  Port of `rick_tpu/nn/generator.py`.

`Generator(size, ...)` keeps rosinality's constructor and state-dict layout;
`GeneratorConfig` is the JAX package's config, with the same fields and
properties.  All randomness comes from explicit `torch.Generator`s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from rick_tpu_torch.nn.blocks import ConstantInput, EqualLinear, PixelNorm, StyledConv, ToRGB

CHANNELS_BASE = {4: 512, 8: 512, 16: 512, 32: 512}


def channel_table(channel_multiplier: int) -> dict:
    cm = channel_multiplier
    return {
        **CHANNELS_BASE,
        64: 256 * cm,
        128: 128 * cm,
        256: 64 * cm,
        512: 32 * cm,
        1024: 16 * cm,
    }


@dataclass(frozen=True)
class GeneratorConfig:
    size: int = 256
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    lr_mlp: float = 0.01

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def channels(self) -> dict:
        return channel_table(self.channel_multiplier)


class Generator(nn.Module):
    """Weights are drawn from `rng` (a `torch.Generator` on `device`) with
    rosinality's distributions: randn weights, zero biases and noise
    weights, modulation bias 1, randn constant input and noise buffers."""

    def __init__(
        self,
        size: int = 256,
        style_dim: int = 512,
        n_mlp: int = 8,
        channel_multiplier: int = 2,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        lr_mlp: float = 0.01,
        *,
        rng: torch.Generator,
        device=None,
    ):
        super().__init__()
        cfg = GeneratorConfig(size, style_dim, n_mlp, channel_multiplier, tuple(blur_kernel), lr_mlp)
        self.cfg = cfg
        ch = cfg.channels
        bk = cfg.blur_kernel
        kw = dict(rng=rng, device=device)

        self.style = nn.Sequential(
            PixelNorm(),
            *[
                EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu", **kw)
                for _ in range(n_mlp)
            ],
        )
        self.input = ConstantInput(ch[4], **kw)
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim, blur_kernel=bk, **kw)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, blur_kernel=bk, **kw)

        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, cfg.log_size + 1):
            out_ch = ch[2**i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim, upsample=True, blur_kernel=bk, **kw))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim, blur_kernel=bk, **kw))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, blur_kernel=bk, **kw))
            in_ch = out_ch

        # fixed noise buffers: layer j at 2^((j+5)//2)
        self.noises = nn.Module()
        for j in range(cfg.num_layers):
            res = 2 ** ((j + 5) // 2)
            self.noises.register_buffer(f"noise_{j}", torch.randn((1, 1, res, res), generator=rng, device=device))

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    def style_forward(self, z):
        """PixelNorm + n_mlp EqualLinear(fused_lrelu)."""
        return self.style(z)

    def mean_latent(self, n_latent: int, rng: torch.Generator):
        z = torch.randn((n_latent, self.cfg.style_dim), generator=rng, device=self.device)
        return self.style_forward(z).mean(0, keepdim=True)

    def make_latent(
        self,
        styles: Sequence[torch.Tensor],
        *,
        inject_index: Union[int, torch.Tensor, None] = None,
        truncation: float = 1.0,
        truncation_latent: Optional[torch.Tensor] = None,
        input_is_latent: bool = False,
    ):
        """The (B, n_latent, style_dim) per-layer latent: style mixing (layer
        i takes styles[1] iff i >= inject_index, default n_latent // 2; an
        index tensor gives one index per sample) and truncation."""
        if not input_is_latent:
            styles = [self.style_forward(s) for s in styles]
        if truncation < 1.0:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]

        n_latent = self.cfg.n_latent
        if len(styles) == 1:
            if styles[0].ndim == 3:
                return styles[0]
            return styles[0][:, None, :].repeat(1, n_latent, 1)

        if inject_index is None:
            inject_index = n_latent // 2
        layer_idx = torch.arange(n_latent, device=styles[0].device)[None, :, None]
        inject = torch.as_tensor(inject_index, device=styles[0].device).reshape(-1, 1, 1)
        return torch.where(layer_idx < inject, styles[0][:, None, :], styles[1][:, None, :])

    def layer_noise(self, batch: int, rng: Optional[torch.Generator], noise) -> List[torch.Tensor]:
        """Per-layer noise: explicit > fresh from `rng` > the constant buffers."""
        if noise is not None:
            return list(noise)
        if rng is not None:
            return [
                torch.randn((batch, 1, 2 ** ((j + 5) // 2), 2 ** ((j + 5) // 2)), generator=rng, device=self.device)
                for j in range(self.cfg.num_layers)
            ]
        return [getattr(self.noises, f"noise_{j}") for j in range(self.cfg.num_layers)]

    def forward(
        self,
        styles: Sequence[torch.Tensor],
        *,
        rng: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        inject_index=None,
        truncation: float = 1.0,
        truncation_latent=None,
        input_is_latent: bool = False,
        return_latents: bool = False,
        return_feats: bool = False,
        dtype: torch.dtype = torch.float32,
        fast: bool = False,
    ):
        """Returns (image, aux): aux is the latent (return_latents), the list
        of StyledConv outputs (return_feats), or None.  `rng=None` and
        `noise=None` select the registered constant noise buffers.
        `fast=True` runs the upsample StyledConvs through the fused
        `convt_blur_act` kernel and the f32 stride-1 StyledConvs through
        `modconv_act`, both forward only: for generation, not for a pass
        that is differentiated.

        `dtype` is the trunk's compute dtype, as `generator_apply_latent`'s:
        the constant input is cast to it, and each layer computes in its
        input's dtype.  With bf16 that is the first StyledConv alone (K3's
        bf16 instantiation), whose f32 activation bias makes its output f32,
        so every later layer, feature and the image are f32, as in rick_tpu.
        The style MLP and the latent are f32 either way."""
        latent = self.make_latent(
            styles,
            inject_index=inject_index,
            truncation=truncation,
            truncation_latent=truncation_latent,
            input_is_latent=input_is_latent,
        )
        noise = self.layer_noise(latent.shape[0], rng, noise)

        feats = []
        out = self.input(latent.shape[0], dtype)
        out = self.conv1(out, latent[:, 0], noise[0], fast=fast)
        feats.append(out)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for block, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * block](out, latent[:, i], noise[2 * block + 1], fast=fast)
            feats.append(out)
            out = self.convs[2 * block + 1](out, latent[:, i + 1], noise[2 * block + 2], fast=fast)
            feats.append(out)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2

        if return_latents:
            return skip, latent
        if return_feats:
            return skip, feats
        return skip, None
