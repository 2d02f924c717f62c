"""Fused upsample StyledConv: transposed conv (3x3, stride 2) + 4-tap FIR blur
+ demod + noise + bias + leaky-ReLU in one CUDA kernel.

Port of `rick_tpu/ops/fused_upsample.py`.  `convt_blur_act` launches
`csrc/convt_blur_act.cu` for CUDA tensors and takes `convt_blur_act_ref`, the
unfused chain, for CPU tensors.  The kernel keeps the (2H+1)^2 mid activation
of the transposed conv in shared memory; the unfused chain writes and reads
it several times.  Forward only.

`convt_blur_act_stage` (K5) launches the same kernel cut after one of its
stages (load, conv, blur, full), the counterpart of the Pallas ablation
`scripts/bench_fused_ablate.py`; `convt_blur_act_stage_ref` is its plain
version.  `tools/bench_fused_ablate.py` times it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rick_tpu_torch.ops import _build
from rick_tpu_torch.ops.kernels import _require, check_cuda_f32, forbid_autograd
from rick_tpu_torch.ops.resample import blur

# K5's stages, in the kernel's order (the `stage` argument of the entry point)
STAGES = ("load", "conv", "blur", "full")


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


def _launch(name: str, stage: str, xs, weight, demod, noise, act_bias, *,
            blur_kernel, slope, gain, use_act) -> torch.Tensor:
    """Check the arguments of the fused upsample kernel and launch it cut
    after `stage` ("full" is the whole kernel); returns the (N, Cout, 2H, 2W)
    output."""
    _require(xs.device.type == "cuda", f"{name}: unsupported device {xs.device}")
    _require(xs.ndim == 4, f"{name}: xs must be 4-D, got {tuple(xs.shape)}")
    N, Cin, H, W = xs.shape
    Cout = weight.shape[0]
    _require(
        tuple(weight.shape) == (Cout, Cin, 3, 3),
        f"{name}: weight {tuple(weight.shape)} is not ({Cout}, {Cin}, 3, 3)",
    )
    _require(len(blur_kernel) == 4, f"{name}: the kernel takes a 4-tap blur only")
    _require(Cout % 4 == 0, f"{name}: Cout {Cout} must be a multiple of 4")
    _require(tuple(demod.shape) == (N, Cout), f"{name}: demod {tuple(demod.shape)} != ({N}, {Cout})")
    _require(
        tuple(noise.shape) in ((N, 1, 2 * H, 2 * W), (1, 1, 2 * H, 2 * W)),
        f"{name}: noise {tuple(noise.shape)} is not ({N}|1, 1, {2 * H}, {2 * W})",
    )
    if act_bias is None:
        act_bias = torch.zeros(Cout, device=xs.device)
    _require(tuple(act_bias.shape) == (Cout,), f"{name}: bias {tuple(act_bias.shape)} != ({Cout},)")
    tensors = dict(xs=xs, weight=weight, demod=demod, noise=noise, act_bias=act_bias)
    check_cuda_f32(name, xs.device, **tensors)
    forbid_autograd(name, **tensors)
    # (Cout, Cin, 3, 3) -> (Cin, 9, Cout): a block's 32 output channels of one
    # (ci, tap) are one contiguous run
    wt = weight.permute(1, 2, 3, 0).contiguous()
    y = torch.empty((N, Cout, 2 * H, 2 * W), device=xs.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    k0, k1, k2, k3 = blur_taps(blur_kernel)
    code = _build.lib().rick_convt_blur_act_stage(
        xs.data_ptr(), wt.data_ptr(), demod.data_ptr(), noise.data_ptr(),
        act_bias.data_ptr(), y.data_ptr(), N, Cin, Cout, H, W, int(noise.shape[0] == N),
        k0, k1, k2, k3, int(use_act), float(slope), float(gain), STAGES.index(stage),
        _build.stream_ptr(xs.device),
    )
    _build.check(code, name)
    return y


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
    kw = dict(blur_kernel=blur_kernel, slope=slope, gain=gain, use_act=use_act)
    if xs.device.type == "cpu":
        return convt_blur_act_ref(xs, weight, demod, noise, act_bias, **kw)
    y = _launch("convt_blur_act", "full", xs, weight, demod, noise, act_bias, **kw)
    convt_blur_act.launches += 1
    return y


convt_blur_act.launches = 0


def convt_blur_act_stage_ref(stage: str, xs, weight, demod, noise, act_bias, **kw):
    """The plain version of the kernel cut after `stage`: zeros, the
    transposed conv cropped to (2H, 2W), its blur (no demod, noise, bias or
    activation), or the whole chain."""
    _require(stage in STAGES, f"convt_blur_act_stage: stage {stage!r} is not one of {STAGES}")
    N, _, H, W = xs.shape
    Cout = weight.shape[0]
    if stage == "load":
        return torch.zeros((N, Cout, 2 * H, 2 * W), device=xs.device, dtype=xs.dtype)
    if stage == "conv":
        return F.conv_transpose2d(xs, weight.transpose(0, 1), stride=2)[..., : 2 * H, : 2 * W]
    if stage == "blur":
        ones = torch.ones((N, Cout), device=xs.device, dtype=xs.dtype)
        zeros = torch.zeros((1, 1, 2 * H, 2 * W), device=xs.device, dtype=xs.dtype)
        blur_kernel = kw.get("blur_kernel", (1, 3, 3, 1))
        return convt_blur_act_ref(xs, weight, ones, zeros, None, blur_kernel=blur_kernel, use_act=False)
    return convt_blur_act_ref(xs, weight, demod, noise, act_bias, **kw)


def convt_blur_act_stage(
    stage: str,
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
    """K5: the fused upsample kernel cut after `stage` (one of `STAGES`), with
    the arguments of `convt_blur_act`; "full" is `convt_blur_act` itself.
    `convt_blur_act_stage.launches` counts launches per stage."""
    _require(stage in STAGES, f"convt_blur_act_stage: stage {stage!r} is not one of {STAGES}")
    kw = dict(blur_kernel=blur_kernel, slope=slope, gain=gain, use_act=use_act)
    if xs.device.type == "cpu":
        return convt_blur_act_stage_ref(stage, xs, weight, demod, noise, act_bias, **kw)
    y = _launch("convt_blur_act_stage", stage, xs, weight, demod, noise, act_bias, **kw)
    convt_blur_act_stage.launches[stage] += 1
    return y


convt_blur_act_stage.launches = dict.fromkeys(STAGES, 0)
