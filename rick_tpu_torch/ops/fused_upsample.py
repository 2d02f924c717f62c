"""Fused upsample StyledConv: transposed conv (3x3, stride 2) + 4-tap FIR blur
+ demod + noise + bias + leaky-ReLU in one CUDA kernel.

Port of `rick_tpu/ops/fused_upsample.py`.  `convt_blur_act` launches
`csrc/convt_blur_act.cu` for CUDA tensors and takes `convt_blur_act_ref`, the
unfused chain, for CPU tensors.  The kernel keeps the (2H+1)^2 mid activation
of the transposed conv in shared memory; the unfused chain writes and reads
it several times.  Forward only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rick_tpu_torch.ops import _build
from rick_tpu_torch.ops.kernels import _require, check_cuda_f32
from rick_tpu_torch.ops.resample import blur


def convt_blur_act_ref(
    xs, weight, demod, noise, act_bias, *,
    blur_kernel=(1, 3, 3, 1), slope=0.2, gain=math.sqrt(2.0), use_act=True,
):
    """The unfused chain, with the same semantics as the kernel."""
    kh = weight.shape[2]
    out = F.conv_transpose2d(xs, weight.transpose(0, 1), stride=2)
    out = out * demod[:, :, None, None]
    p = (len(blur_kernel) - 2) - (kh - 1)
    out = blur(out, blur_kernel, pad=((p + 1) // 2 + 1, p // 2 + 1), upsample_factor=2)
    out = out + noise
    if act_bias is not None:
        out = out + act_bias.reshape(1, -1, 1, 1)
    if use_act:
        out = torch.where(out >= 0, out, out * slope) * gain
    return out


def blur_taps(blur_kernel) -> tuple:
    """Per-axis correlation taps of the upsample blur: the 1-D kernel,
    normalized, times the per-axis gain 2, flipped (upfirdn2d convolves)."""
    k = np.asarray(blur_kernel, np.float64)
    k = k / k.sum() * 2.0
    return tuple(float(v) for v in k[::-1])


def convt_blur_act(
    xs: torch.Tensor,
    weight: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    act_bias,
    *,
    blur_kernel=(1, 3, 3, 1),
    slope: float = 0.2,
    gain: float = math.sqrt(2.0),
    use_act: bool = True,
) -> torch.Tensor:
    """y = lrelu(blur(demod * convT2x(xs, weight)) + noise + bias) * gain.

    xs: (N, Cin, H, W) style-premultiplied input; weight: (Cout, Cin, 3, 3)
    ALREADY scaled by 1/sqrt(fan_in); demod: (N, Cout); noise: (N|1, 1, 2H, 2W)
    ALREADY scaled by the layer's noise weight; act_bias: (Cout,) or None
    (zeros).  Returns (N, Cout, 2H, 2W)."""
    if xs.device.type == "cpu":
        return convt_blur_act_ref(
            xs, weight, demod, noise, act_bias,
            blur_kernel=blur_kernel, slope=slope, gain=gain, use_act=use_act,
        )
    _require(xs.device.type == "cuda", f"convt_blur_act: unsupported device {xs.device}")
    _require(xs.ndim == 4, f"convt_blur_act: xs must be 4-D, got {tuple(xs.shape)}")
    N, Cin, H, W = xs.shape
    Cout = weight.shape[0]
    _require(
        tuple(weight.shape) == (Cout, Cin, 3, 3),
        f"convt_blur_act: weight {tuple(weight.shape)} is not ({Cout}, {Cin}, 3, 3)",
    )
    _require(len(blur_kernel) == 4, "convt_blur_act: the kernel takes a 4-tap blur only")
    _require(Cout % 4 == 0, f"convt_blur_act: Cout {Cout} must be a multiple of 4")
    _require(tuple(demod.shape) == (N, Cout), f"convt_blur_act: demod {tuple(demod.shape)} != ({N}, {Cout})")
    _require(
        tuple(noise.shape) in ((N, 1, 2 * H, 2 * W), (1, 1, 2 * H, 2 * W)),
        f"convt_blur_act: noise {tuple(noise.shape)} is not ({N}|1, 1, {2 * H}, {2 * W})",
    )
    if act_bias is None:
        act_bias = torch.zeros(Cout, device=xs.device)
    _require(tuple(act_bias.shape) == (Cout,), f"convt_blur_act: bias {tuple(act_bias.shape)} != ({Cout},)")
    check_cuda_f32(
        "convt_blur_act", xs.device,
        xs=xs, weight=weight, demod=demod, noise=noise, act_bias=act_bias,
    )
    # (Cout, Cin, 3, 3) -> (Cin, 9, Cout): a block's 32 output channels of one
    # (ci, tap) are one contiguous run
    wt = weight.permute(1, 2, 3, 0).contiguous()
    y = torch.empty((N, Cout, 2 * H, 2 * W), device=xs.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    k0, k1, k2, k3 = blur_taps(blur_kernel)
    code = _build.lib().rick_convt_blur_act(
        xs.data_ptr(), wt.data_ptr(), demod.data_ptr(), noise.data_ptr(),
        act_bias.data_ptr(), y.data_ptr(), N, Cin, Cout, H, W, int(noise.shape[0] == N),
        k0, k1, k2, k3, int(use_act), float(slope), float(gain), _build.stream_ptr(xs.device),
    )
    _build.check(code, "convt_blur_act")
    convt_blur_act.launches += 1
    return y


convt_blur_act.launches = 0
