"""Fused bias + leaky-ReLU + gain.  Port of `rick_tpu/ops/fused_act.py`.

    y = leaky_relu(x + bias[c], negative_slope) * scale

with the bias on the last dim of a 2-D input and on dim 1 otherwise, through
the twice-differentiable `FusedBiasAct` (`ops/kernels.py`): a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the `fused_bias_act` kernel
forward and the `fused_bias_act_bwd` kernel backward.
"""

from __future__ import annotations

import torch

from rick_tpu_torch.ops.kernels import SQRT2, fused_bias_act


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2, scale: float = SQRT2):
    """y = leaky_relu(x + bias) * scale; `bias=None` means no bias."""
    if bias is None:
        channels = x.shape[-1] if x.ndim == 2 else x.shape[1]
        bias = torch.zeros(channels, dtype=x.dtype, device=x.device)
    return fused_bias_act(x, bias, negative_slope, scale)


def scaled_leaky_relu(x, negative_slope: float = 0.2):
    """rosinality `ScaledLeakyReLU`: no bias, gain sqrt(2)."""
    return torch.where(x >= 0, x, x * negative_slope) * SQRT2


def fused_leaky_relu_kml(x, bias, b_vector=None, negative_slope: float = 0.2, scale: float = SQRT2):
    """Kernel-modulation variant: the activation bias is `bias + b_vector`
    when the additive vector is given, else `bias`."""
    eff = bias if b_vector is None else bias + b_vector
    return fused_leaky_relu(x, eff, negative_slope, scale)
