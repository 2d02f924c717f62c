"""Modulated 3x3 conv + epilogue in one CUDA kernel (K6), for generation.

    y = lrelu(demod[b,o] * conv3x3(x * s[b,i], w)[b,o] + nw * noise[b|0] + bias[o]) * gain

The chain the plain StyledConv runs (`x * s`, the stride-1 conv with
padding 1, then `modconv_epilogue`'s demod, noise, bias and activation) as
one kernel, `csrc/modconv_act.cu`, which runs the conv as an implicit GEMM on
the tensor cores in 3xTF32 (f32 accuracy).  It replaces no Pallas kernel:
rick_tpu leaves that conv to XLA and runs the epilogue as
`_epi_fwd_kernel` (K3's Pallas original).

`modconv_act` launches the kernel for CUDA tensors and takes
`modconv_act_ref`, the unfused chain, for CPU tensors.  Forward only and f32
only: it raises where autograd would record it, on another dtype, and on a
shape it does not take.  `modconv_act.launches` counts launches; inside
`utils.trace.recording()` each call is counted under `ops.modconv_act`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rick_tpu_torch.ops import _build
from rick_tpu_torch.ops.fused_upsample import _kernel_weights as _quad_weights
from rick_tpu_torch.ops.kernels import SQRT2, _require, check_cuda, forbid_autograd, modconv_epilogue_ref
from rick_tpu_torch.utils.trace import count

CO_TILE = 128  # output channels per block of the kernel
CIN_STAGE = 8  # input channels per stage of the kernel


def modconv_act_ref(x, s, weight, demod, noise, noise_weight, bias, slope: float = 0.2, gain: float = SQRT2):
    """The unfused chain, with the same semantics as the kernel."""
    out = F.conv2d(x * s[:, :, None, None], weight, padding=1)
    return modconv_epilogue_ref(out, demod, noise, noise_weight, bias, slope, gain)


def _kernel_weights(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (ceil(Cout/128), 2 ceil(Cin/8), 9, 2, 128, 4),
    the kernel's B operand: per block of 128 output channels, per 4 input
    channels, tap and output channel, the TF32 hi and lo parts of each weight,
    4 channels to a 16-byte row (K-major core matrices); zero past Cout and
    Cin.  One stage of the kernel (8 input channels of one block) is one
    contiguous block of 73,728 bytes."""
    cout, cin = weight.shape[:2]
    cout_p = -(-cout // CO_TILE) * CO_TILE
    cin_p = -(-cin // CIN_STAGE) * CIN_STAGE
    wt = _quad_weights(F.pad(weight, (0, 0, 0, 0, 0, cin_p - cin, 0, cout_p - cout)))
    return wt.view(cin_p // 4, 9, 2, cout_p // CO_TILE, CO_TILE, 4).permute(3, 0, 1, 2, 4, 5).contiguous()


def _launch(x, s, weight, demod, noise, noise_weight, bias, slope: float, gain: float) -> torch.Tensor:
    name = "modconv_act"
    _require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    _require(x.ndim == 4, f"{name}: x must be 4-D, got {tuple(x.shape)}")
    N, Cin, H, W = x.shape
    Cout = weight.shape[0]
    _require(tuple(weight.shape) == (Cout, Cin, 3, 3), f"{name}: weight {tuple(weight.shape)} is not ({Cout}, {Cin}, 3, 3)")
    _require(tuple(s.shape) == (N, Cin), f"{name}: s {tuple(s.shape)} != ({N}, {Cin})")
    _require(tuple(demod.shape) == (N, Cout), f"{name}: demod {tuple(demod.shape)} != ({N}, {Cout})")
    _require(
        tuple(noise.shape) in ((N, 1, H, W), (1, 1, H, W)),
        f"{name}: noise {tuple(noise.shape)} is not ({N}|1, 1, {H}, {W})",
    )
    _require(noise_weight.numel() == 1, f"{name}: noise_weight must have one element")
    _require(tuple(bias.shape) == (Cout,), f"{name}: bias {tuple(bias.shape)} != ({Cout},)")
    tensors = dict(x=x, s=s, weight=weight, demod=demod, noise=noise, noise_weight=noise_weight, bias=bias)
    check_cuda(name, x.device, torch.float32, **tensors)
    forbid_autograd(name, **tensors)
    y = torch.empty((N, Cout, H, W), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    wt = _kernel_weights(weight)
    # the kernel reads x by TMA, in rows a multiple of 16 bytes apart from a
    # 16-byte aligned base: rows of a width that is not a multiple of 4 are
    # padded (the kernel bounds its reads by W, so the padding is never read)
    if W % 4:
        x = F.pad(x, (0, -W % 4))
    elif x.data_ptr() % 16:
        x = x.clone()
    code = _build.lib().rick_modconv_act(
        x.data_ptr(), wt.data_ptr(), s.data_ptr(), demod.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        bias.data_ptr(), y.data_ptr(), N, Cin, Cout, H, W, int(noise.shape[0] == N), float(slope), float(gain),
        _build.stream_ptr(x.device),
    )
    _build.check(code, name)
    return y


def modconv_act(
    x: torch.Tensor,
    s: torch.Tensor,
    weight: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    noise_weight: torch.Tensor,
    bias: torch.Tensor,
    slope: float = 0.2,
    gain: float = SQRT2,
) -> torch.Tensor:
    """y = lrelu(demod * conv2d(x * s, weight, padding=1) + nw * noise + bias) * gain.

    x: (N, Cin, H, W); s: (N, Cin), the style; weight: (Cout, Cin, 3, 3)
    ALREADY scaled by 1/sqrt(fan_in); demod: (N, Cout); noise: (N|1, 1, H, W)
    and noise_weight a one-element tensor (read on the device); bias:
    (Cout,).  Returns (N, Cout, H, W).  Forward only, f32 only."""
    with count("ops.modconv_act"):
        if x.device.type == "cpu":
            return modconv_act_ref(x, s, weight, demod, noise, noise_weight, bias, slope, gain)
        y = _launch(x, s, weight, demod, noise, noise_weight, bias, slope, gain)
        modconv_act.launches += 1
        return y


modconv_act.launches = 0
