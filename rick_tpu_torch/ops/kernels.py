"""Fused bias + leaky-ReLU and the modconv epilogue: CUDA kernels and their
plain PyTorch versions.

Port of the two Pallas kernels of `rick_tpu/ops/pallas_kernels.py`:

  * `fused_bias_act`   <- `fused_bias_act_pallas` forward (`_fba_fwd_kernel`)
        y = leaky_relu(x + bias[c], slope) * scale
  * `modconv_epilogue` <- `modconv_epilogue_pallas` forward (`_epi_fwd_kernel`)
        y = leaky_relu(out * demod[b,c] + nw * noise[b|0,0,h,w] + bias[c], slope) * scale

Each wrapper takes its plain version for a tensor on the CPU, launches its
kernel (`csrc/fused_bias_act.cu`, `csrc/modconv_epilogue.cu`) for a CUDA
tensor, and raises on anything else.  The kernels are forward only: called
where autograd would record them, the wrappers raise NotImplementedError
rather than return a tensor without a gradient.  `<wrapper>.launches` counts
kernel launches.
"""

from __future__ import annotations

import math

import torch

from rick_tpu_torch.ops import _build

SQRT2 = math.sqrt(2.0)


def _lrelu(v, slope: float, scale: float):
    return torch.where(v >= 0, v, v * slope) * scale


def _bias_view(bias: torch.Tensor, ndim: int) -> torch.Tensor:
    """Bias on the last dim for 2-D input, on dim 1 otherwise."""
    if ndim == 2:
        return bias.reshape(1, -1)
    return bias.reshape((1, -1) + (1,) * (ndim - 2))


def fused_bias_act_ref(x, bias, slope: float = 0.2, scale: float = SQRT2):
    return _lrelu(x + _bias_view(bias, x.ndim), slope, scale)


def modconv_epilogue_ref(out, demod, noise, noise_weight, bias, slope: float = 0.2, scale: float = SQRT2):
    v = out * demod[:, :, None, None] + noise_weight.reshape(()) * noise + bias.reshape(1, -1, 1, 1)
    return _lrelu(v, slope, scale)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda_f32(name: str, device: torch.device, **tensors) -> None:
    """Device, dtype, contiguity and autograd checks shared by the wrappers."""
    for k, t in tensors.items():
        _require(t.device == device, f"{name}: {k} is on {t.device}, expected {device}")
        _require(t.dtype == torch.float32, f"{name}: {k} has dtype {t.dtype}, expected float32")
        _require(t.is_contiguous(), f"{name}: {k} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; run it under torch.no_grad() "
            "or torch.inference_mode()"
        )


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor, slope: float = 0.2, scale: float = SQRT2):
    """y = leaky_relu(x + bias, slope) * scale; bias (C,) on the last dim of a
    2-D x and on dim 1 of an N-D x (N >= 3)."""
    if x.device.type == "cpu":
        return fused_bias_act_ref(x, bias, slope, scale)
    _require(x.device.type == "cuda", f"fused_bias_act: unsupported device {x.device}")
    _require(x.ndim >= 2, f"fused_bias_act: x must be at least 2-D, got {tuple(x.shape)}")
    C = x.shape[-1] if x.ndim == 2 else x.shape[1]
    _require(tuple(bias.shape) == (C,), f"fused_bias_act: bias {tuple(bias.shape)} != ({C},)")
    check_cuda_f32("fused_bias_act", x.device, x=x, bias=bias)
    inner = 1 if x.ndim == 2 else math.prod(x.shape[2:])
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    code = _build.lib().rick_fused_bias_act(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(), C, inner,
        float(slope), float(scale), _build.stream_ptr(x.device),
    )
    _build.check(code, "fused_bias_act")
    fused_bias_act.launches += 1
    return y


fused_bias_act.launches = 0


def modconv_epilogue(
    out: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    noise_weight: torch.Tensor,
    bias: torch.Tensor,
    slope: float = 0.2,
    scale: float = SQRT2,
):
    """y = leaky_relu(out*demod[b,c] + nw*noise[b|0,0,h,w] + bias[c]) * scale.

    out (B,C,H,W), demod (B,C), noise (B,1,H,W) or (1,1,H,W), noise_weight a
    one-element tensor (read on the device: no host sync), bias (C,)."""
    if out.device.type == "cpu":
        return modconv_epilogue_ref(out, demod, noise, noise_weight, bias, slope, scale)
    _require(out.device.type == "cuda", f"modconv_epilogue: unsupported device {out.device}")
    _require(out.ndim == 4, f"modconv_epilogue: out must be 4-D, got {tuple(out.shape)}")
    B, C, H, W = out.shape
    _require(tuple(demod.shape) == (B, C), f"modconv_epilogue: demod {tuple(demod.shape)} != ({B}, {C})")
    _require(
        tuple(noise.shape) in ((B, 1, H, W), (1, 1, H, W)),
        f"modconv_epilogue: noise {tuple(noise.shape)} is not ({B}|1, 1, {H}, {W})",
    )
    _require(noise_weight.numel() == 1, "modconv_epilogue: noise_weight must have one element")
    _require(tuple(bias.shape) == (C,), f"modconv_epilogue: bias {tuple(bias.shape)} != ({C},)")
    check_cuda_f32(
        "modconv_epilogue", out.device,
        out=out, demod=demod, noise=noise, noise_weight=noise_weight, bias=bias,
    )
    y = torch.empty_like(out)
    if out.numel() == 0:
        return y
    code = _build.lib().rick_modconv_epilogue(
        out.data_ptr(), demod.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(),
        bias.data_ptr(), y.data_ptr(), B, C, H * W, int(noise.shape[0] == B),
        float(slope), float(scale), _build.stream_ptr(out.device),
    )
    _build.check(code, "modconv_epilogue")
    modconv_epilogue.launches += 1
    return y


modconv_epilogue.launches = 0
