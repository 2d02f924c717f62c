"""StyleGAN2 Discriminator.  Port of `rick_tpu/nn/discriminator.py`.

Returns (score (B, 1), feats) with the JAX package's feature taps: the
from_rgb output, then (conv1, conv2) of every ResBlock, then the final_conv
output.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch import nn

from rick_tpu_torch.nn.blocks import ConvLayer, EqualLinear, ResBlock, minibatch_stddev
from rick_tpu_torch.nn.generator import channel_table


@dataclass(frozen=True)
class DiscriminatorConfig:
    size: int = 256
    channel_multiplier: int = 2
    blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    stddev_group: int = 25
    stddev_feat: int = 1

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def channels(self) -> dict:
        return channel_table(self.channel_multiplier)


class Discriminator(nn.Module):
    """Weights are drawn from `rng` (a `torch.Generator` on `device`):
    randn weights, zero biases."""

    def __init__(
        self,
        size: int = 256,
        channel_multiplier: int = 2,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        stddev_group: int = 25,
        stddev_feat: int = 1,
        *,
        rng: torch.Generator,
        device=None,
    ):
        super().__init__()
        cfg = DiscriminatorConfig(size, channel_multiplier, tuple(blur_kernel), stddev_group, stddev_feat)
        self.cfg = cfg
        ch = cfg.channels
        bk = cfg.blur_kernel
        kw = dict(rng=rng, device=device)

        self.convs = nn.ModuleList([ConvLayer(3, ch[size], 1, blur_kernel=bk, **kw)])
        in_ch = ch[size]
        for i in range(cfg.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.convs.append(ResBlock(in_ch, out_ch, blur_kernel=bk, **kw))
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3, blur_kernel=bk, **kw)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu", **kw),
            EqualLinear(ch[4], 1, **kw),
        )

    def forward(self, x, *, stddev_splits: int = 1):
        """`stddev_splits=s` takes the minibatch-stddev statistics within `s`
        contiguous sub-batches (equal to `s` separate forwards)."""
        feats = []
        out = self.convs[0](x)
        feats.append(out)
        for block in self.convs[1:]:
            out, f1, f2 = block(out)
            feats.append(f1)
            feats.append(f2)

        batch = out.shape[0]
        out = minibatch_stddev(
            out, stddev_group=self.cfg.stddev_group, stddev_feat=self.cfg.stddev_feat,
            splits=stddev_splits,
        )
        out = self.final_conv(out)
        feats.append(out)
        out = self.final_linear(out.reshape(batch, -1))
        return out, feats
