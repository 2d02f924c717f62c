"""upfirdn2d: upsample -> FIR filter -> downsample, in plain PyTorch.

Port of `rick_tpu/ops/resample.py`.  The chain per channel:

    1. zero-insertion upsample by (up_y, up_x); the up-1 trailing zeros of each
       axis fold into the high pad
    2. pad spatially by (pad_y0, pad_y1, pad_x0, pad_x1)  (negative pad = crop)
    3. true 2-D convolution with `kernel` (`F.conv2d` correlates, so the
       kernel is flipped first)
    4. stride-downsample by (down_y, down_x)

    out_h = (in_h * up_y + pad_y0 + pad_y1 - kernel_h) // down_y + 1

Everything is differentiable by autograd to any order.  `blur`,
`upsample2d` and `downsample2d` take one lowering: a single 2-D depthwise
pass, which reads and writes the activation once (the JAX package chose
between that and a separable two-pass form by size, on the TPU).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

KernelSpec = Union[Sequence[float], torch.Tensor]


def make_kernel(k: KernelSpec, device=None) -> torch.Tensor:
    """Normalized 2-D FIR kernel from a 1-D or 2-D spec: a 1-D spec is
    outer-producted with itself, then the kernel is scaled to sum to 1."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d_general(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up_x: int = 1,
    up_y: int = 1,
    down_x: int = 1,
    down_y: int = 1,
    pad_x0: int = 0,
    pad_x1: int = 0,
    pad_y0: int = 0,
    pad_y1: int = 0,
) -> torch.Tensor:
    """General per-axis upfirdn2d on NCHW input; `kernel` is 2-D (kh, kw)."""
    n, c, in_h, in_w = x.shape
    kh, kw = kernel.shape
    out_h = (in_h * up_y + pad_y0 + pad_y1 - kh) // down_y + 1
    out_w = (in_w * up_x + pad_x0 + pad_x1 - kw) // down_x + 1
    if out_h <= 0 or out_w <= 0:
        raise ValueError(
            f"upfirdn2d output would be empty: in=({in_h},{in_w}) up=({up_y},{up_x}) "
            f"down=({down_y},{down_x}) pad=({pad_y0},{pad_y1},{pad_x0},{pad_x1}) k=({kh},{kw})"
        )

    out = x.reshape(n * c, in_h, 1, in_w, 1)
    # zero-insertion: each sample followed by up-1 zeros (the trailing ones
    # land beyond the last sample, i.e. in the high pad)
    out = F.pad(out, [0, up_x - 1, 0, 0, 0, up_y - 1])
    out = out.reshape(n * c, 1, in_h * up_y, in_w * up_x)
    out = F.pad(out, [max(pad_x0, 0), max(pad_x1, 0), max(pad_y0, 0), max(pad_y1, 0)])
    out = out[
        :,
        :,
        max(-pad_y0, 0) : out.shape[2] - max(-pad_y1, 0),
        max(-pad_x0, 0) : out.shape[3] - max(-pad_x1, 0),
    ]
    w = torch.flip(kernel, (0, 1)).to(out.dtype)[None, None]
    out = F.conv2d(out, w, stride=(down_y, down_x))
    return out.reshape(n, c, out_h, out_w)


def upfirdn2d(x, kernel: torch.Tensor, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Symmetric-factor upfirdn2d (the reference's public dispatch)."""
    return upfirdn2d_general(x, kernel, up, up, down, down, pad[0], pad[1], pad[0], pad[1])


def upfirdn2d_separable(x, k1d: KernelSpec, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """upfirdn2d with the rank-1 kernel outer(k1d, k1d), as two 1-D passes
    (exactly equal to the 2-D form: zero-insert, pad, convolve and stride all
    factor per axis)."""
    k = torch.as_tensor(k1d, dtype=torch.float32, device=x.device)
    x = upfirdn2d_general(x, k[:, None], 1, up, 1, down, 0, 0, pad[0], pad[1])
    return upfirdn2d_general(x, k[None, :], up, 1, down, 1, pad[0], pad[1], 0, 0)


def upsample2d(x, kernel: KernelSpec, factor: int = 2) -> torch.Tensor:
    """Antialiased `factor`x upsample (rosinality `Upsample`): kernel gain
    factor**2, padded so that out = in * factor."""
    k = make_kernel(kernel, x.device) * (factor**2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, down=1, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x, kernel: KernelSpec, factor: int = 2) -> torch.Tensor:
    """Antialiased `factor`x downsample (rosinality `Downsample`)."""
    k = make_kernel(kernel, x.device)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x, kernel: KernelSpec, pad, upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (rosinality `Blur`); gain upsample_factor**2 when the blur
    follows a transposed conv."""
    k = make_kernel(kernel, x.device)
    if upsample_factor > 1:
        k = k * (upsample_factor**2)
    return upfirdn2d(x, k, pad=pad)
