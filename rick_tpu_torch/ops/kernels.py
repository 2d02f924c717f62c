"""Fused bias + leaky-ReLU, its backward, and the modconv epilogue: CUDA
kernels, their plain PyTorch versions, and the autograd Functions around them.

Port of the Pallas kernels of `rick_tpu/ops/pallas_kernels.py`:

  * `fused_bias_act`     (K1) <- `fused_bias_act_pallas` forward (`_fba_fwd_kernel`)
        y = leaky_relu(x + bias[c], slope) * scale
  * `fused_bias_act_bwd` (K2) <- `fused_bias_act_pallas` backward (`_fba_bwd_kernel`)
        gx = where(y >= 0, v, slope * v) * scale,  v = g (+ bias[c])
  * `modconv_epilogue`   (K3) <- `modconv_epilogue_pallas` forward (`_epi_fwd_kernel`)
        y = leaky_relu(out * demod[b,c] + nw * noise[b|0,0,h,w] + bias[c], slope) * scale

Each kernel wrapper takes its plain version for a tensor on the CPU, launches
its kernel (`csrc/fused_bias_act.cu`, `csrc/modconv_epilogue.cu`) for a CUDA
tensor, and raises on anything else.  `<wrapper>.launches` counts kernel
launches; inside `utils.trace.recording()` each wrapper call, whatever the
device, is counted under `ops.<wrapper>` with its host time.

K1 and K3 also take bf16, as rick_tpu computes them at the two layers its
`bf16=True` runs in bf16 (G's first StyledConv, D's from-RGB conv): K1 a bf16
x with an f32 bias, K3 bf16 out/demod/noise/noise weight with an f32 bias,
both giving f32 (JAX promotes bf16 + f32 to f32).  A bf16 CUDA tensor
launches the flat bf16 kernel (`fba_bf16_flat`, `epi_bf16_flat`; counted in
`<wrapper>.launches_bf16`); any other dtype raises.  Their backward rounds
the cotangent of each bf16 operand to bf16 once, from the f32 K2 result, as
the transpose of JAX's bf16 -> f32 convert.

`fused_bias_act` and `modconv_epilogue` are differentiable twice, as R1 and
the path-length regularizer need: `FusedBiasAct`'s backward is the Function
`FusedBiasActBackward` (K2 and a bias sum), whose own backward is K2 again
with the bias sum's cotangent as the bias (rosinality's
`FusedLeakyReLUFunctionBackward` pattern); `ModconvEpilogue`'s backward is
`_epi_bwd_rule` written with `FusedBiasActBackward` and differentiable torch
ops.  The sign of the activation comes from the saved output, as in JAX.
"""

from __future__ import annotations

import math

import torch

from rick_tpu_torch.ops import _build
from rick_tpu_torch.utils.trace import count

SQRT2 = math.sqrt(2.0)


def _lrelu(v, slope: float, scale: float):
    return torch.where(v >= 0, v, v * slope) * scale


def _bias_view(bias: torch.Tensor, ndim: int) -> torch.Tensor:
    """Bias on the last dim for 2-D input, on dim 1 otherwise."""
    if ndim == 2:
        return bias.reshape(1, -1)
    return bias.reshape((1, -1) + (1,) * (ndim - 2))


def _bias_sum_dims(ndim: int) -> tuple:
    """The dims a bias gradient sums over: all but the bias dim."""
    return (0,) if ndim == 2 else (0,) + tuple(range(2, ndim))


def fused_bias_act_ref(x, bias, slope: float = 0.2, scale: float = SQRT2):
    return _lrelu(x + _bias_view(bias, x.ndim), slope, scale)


def fused_bias_act_bwd_ref(g, y, bias=None, slope: float = 0.2, scale: float = SQRT2):
    """K2's plain version: where(y >= 0, v, slope * v) * scale, v = g (+ bias)."""
    v = g if bias is None else g + _bias_view(bias, g.ndim)
    return torch.where(y >= 0, v, v * slope) * scale


def modconv_epilogue_ref(out, demod, noise, noise_weight, bias, slope: float = 0.2, scale: float = SQRT2):
    v = out * demod[:, :, None, None] + noise_weight.reshape(()) * noise + bias.reshape(1, -1, 1, 1)
    return _lrelu(v, slope, scale)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(name: str, device: torch.device, dtype: torch.dtype, **tensors) -> None:
    """Device, dtype and contiguity checks shared by the wrappers: each
    tensor on `device`, of `dtype`, contiguous."""
    for k, t in tensors.items():
        _require(t.device == device, f"{name}: {k} is on {t.device}, expected {device}")
        _require(t.dtype == dtype, f"{name}: {k} has dtype {t.dtype}, expected {dtype}")
        _require(t.is_contiguous(), f"{name}: {k} must be contiguous")


def instantiation(name: str, x: torch.Tensor) -> bool:
    """True for the bf16 instantiation, False for the f32 one; any other
    dtype of `x` raises."""
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{name}: dtype {x.dtype}: the kernel takes float32 or bfloat16")
    return x.dtype == torch.bfloat16


def forbid_autograd(name: str, **tensors) -> None:
    """For a forward-only kernel: raise where autograd would record the call,
    rather than return a tensor without a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is not differentiable here; run it under torch.no_grad() "
            "or torch.inference_mode()"
        )


def _channels(x: torch.Tensor) -> int:
    return x.shape[-1] if x.ndim == 2 else x.shape[1]


def _fba_shape_args(name: str, x: torch.Tensor, bias) -> tuple:
    """(C, inner) of the row layout, after the shape checks."""
    _require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    _require(x.ndim >= 2, f"{name}: x must be at least 2-D, got {tuple(x.shape)}")
    C = _channels(x)
    if bias is not None:
        _require(tuple(bias.shape) == (C,), f"{name}: bias {tuple(bias.shape)} != ({C},)")
    inner = 1 if x.ndim == 2 else math.prod(x.shape[2:])
    return C, inner


def _fused_bias_act_fwd(x: torch.Tensor, bias: torch.Tensor, slope: float, scale: float) -> torch.Tensor:
    """K1, or its plain version on the CPU; no autograd."""
    if x.device.type == "cpu":
        return fused_bias_act_ref(x, bias, slope, scale)
    C, inner = _fba_shape_args("fused_bias_act", x, bias)
    bf16 = instantiation("fused_bias_act", x)
    check_cuda("fused_bias_act", x.device, x.dtype, x=x)
    check_cuda("fused_bias_act", x.device, torch.float32, bias=bias)
    y = torch.empty_like(x, dtype=torch.float32)
    if x.numel() == 0:
        return y
    args = (x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(), C, inner, float(slope), float(scale),
            _build.stream_ptr(x.device))
    lib = _build.lib()
    code = lib.rick_fused_bias_act_bf16(*args, None) if bf16 else lib.rick_fused_bias_act(*args)
    _build.check(code, "fused_bias_act")
    if bf16:
        fused_bias_act.launches_bf16 += 1
    else:
        fused_bias_act.launches += 1
    return y


def fused_bias_act_bwd(g: torch.Tensor, y: torch.Tensor, bias=None, slope: float = 0.2, scale: float = SQRT2):
    """K2: gx = where(y >= 0, v, slope * v) * scale with v = g, or v = g +
    bias[c] (bias (C,) on the last dim of a 2-D g, on dim 1 otherwise).

    Not recorded by autograd itself: `FusedBiasActBackward` is its
    differentiable form."""
    with count("ops.fused_bias_act_bwd"):
        if g.device.type == "cpu":
            return fused_bias_act_bwd_ref(g, y, bias, slope, scale)
        C, inner = _fba_shape_args("fused_bias_act_bwd", g, bias)
        _require(y.shape == g.shape, f"fused_bias_act_bwd: y {tuple(y.shape)} != g {tuple(g.shape)}")
        tensors = dict(g=g, y=y) if bias is None else dict(g=g, y=y, bias=bias)
        check_cuda("fused_bias_act_bwd", g.device, torch.float32, **tensors)
        forbid_autograd("fused_bias_act_bwd", **tensors)
        out = torch.empty_like(g)
        if g.numel() == 0:
            return out
        code = _build.lib().rick_fused_bias_act_bwd(
            g.data_ptr(), y.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            g.numel(), C, inner, float(slope), float(scale), _build.stream_ptr(g.device),
        )
        _build.check(code, "fused_bias_act_bwd")
        fused_bias_act_bwd.launches += 1
        return out


fused_bias_act_bwd.launches = 0


class FusedBiasActBackward(torch.autograd.Function):
    """(g, y) -> (gx, gb): the backward of `FusedBiasAct` as a Function of
    its own, so that it can be differentiated once more."""

    @staticmethod
    def forward(ctx, g, y, slope: float, scale: float):
        gx = fused_bias_act_bwd(g.contiguous(), y, None, slope, scale)
        gb = gx.sum(dim=_bias_sum_dims(gx.ndim))
        ctx.save_for_backward(y)
        ctx.slope, ctx.scale = slope, scale
        return gx, gb

    @staticmethod
    def backward(ctx, ggx, ggb):
        # gx and gb are linear in g, through the same mask: d<gx, ggx> +
        # d<gb, ggb> = mask(ggx + ggb[c]).  y only selects the branch, so its
        # gradient is zero.
        (y,) = ctx.saved_tensors
        grad_g = fused_bias_act_bwd(ggx.contiguous(), y, ggb.contiguous(), ctx.slope, ctx.scale)
        return grad_g, None, None, None


class FusedBiasAct(torch.autograd.Function):
    """K1 forward; saves its output, as `_fba_fwd_rule` does."""

    @staticmethod
    def forward(ctx, x, bias, slope: float, scale: float):
        y = _fused_bias_act_fwd(x, bias, slope, scale)
        ctx.save_for_backward(y)
        ctx.slope, ctx.scale, ctx.x_dtype = slope, scale, x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        # y only selects the slope: detached, so that a double backward does
        # not run this backward again on a zero gradient.  gb sums the f32
        # gx; a bf16 x takes gx rounded once.
        (y,) = ctx.saved_tensors
        gx, gb = FusedBiasActBackward.apply(g, y.detach(), ctx.slope, ctx.scale)
        gx = gx.to(ctx.x_dtype) if ctx.needs_input_grad[0] else None
        return gx, (gb if ctx.needs_input_grad[1] else None), None, None


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor, slope: float = 0.2, scale: float = SQRT2):
    """y = leaky_relu(x + bias, slope) * scale; bias (C,) on the last dim of a
    2-D x and on dim 1 of an N-D x (N >= 3).  Differentiable twice."""
    with count("ops.fused_bias_act"):
        return FusedBiasAct.apply(x, bias, slope, scale)


fused_bias_act.launches = 0
fused_bias_act.launches_bf16 = 0


def _modconv_epilogue_fwd(out, demod, noise, noise_weight, bias, slope: float, scale: float):
    """K3, or its plain version on the CPU; no autograd."""
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
    bf16 = instantiation("modconv_epilogue", out)
    check_cuda(
        "modconv_epilogue", out.device, out.dtype,
        out=out, demod=demod, noise=noise, noise_weight=noise_weight,
    )
    check_cuda("modconv_epilogue", out.device, torch.float32, bias=bias)
    y = torch.empty_like(out, dtype=torch.float32)
    if out.numel() == 0:
        return y
    args = (out.data_ptr(), demod.data_ptr(), noise.data_ptr(), noise_weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), B, C, H * W, int(noise.shape[0] == B), float(slope), float(scale),
            _build.stream_ptr(out.device))
    lib = _build.lib()
    code = lib.rick_modconv_epilogue_bf16(*args, None) if bf16 else lib.rick_modconv_epilogue(*args)
    _build.check(code, "modconv_epilogue")
    if bf16:
        modconv_epilogue.launches_bf16 += 1
    else:
        modconv_epilogue.launches += 1
    return y


class ModconvEpilogue(torch.autograd.Function):
    """K3 forward; the backward is `_epi_bwd_rule`: the activation's
    derivative by K2 (no bias), the rest torch products and sums, all
    differentiable, so the epilogue is differentiable twice.  The
    pre-activation's cotangent is f32; with bf16 operands it is rounded to
    bf16 once, and the products and sums that follow run in bf16, as JAX
    differentiates rick_tpu's bf16 chain."""

    @staticmethod
    def forward(ctx, out, demod, noise, noise_weight, bias, slope: float, scale: float):
        y = _modconv_epilogue_fwd(out, demod, noise, noise_weight, bias, slope, scale)
        ctx.save_for_backward(y, out, demod, noise, noise_weight)
        ctx.slope, ctx.scale = slope, scale
        return y

    @staticmethod
    def backward(ctx, g):
        y, out, demod, noise, noise_weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_pre, d_bias = FusedBiasActBackward.apply(g, y.detach(), ctx.slope, ctx.scale)
        g_pre = g_pre.to(out.dtype)
        d_out = g_pre * demod[:, :, None, None] if need[0] else None
        d_demod = (g_pre * out).sum(dim=(2, 3)) if need[1] else None
        # the cotangent of nw * noise: summed over the dims it is broadcast
        # over, the channels and, for one noise map, the batch
        d_prod = g_pre.sum(dim=(1,) if noise.shape[0] == out.shape[0] else (0, 1), keepdim=True)
        d_noise = noise_weight.reshape(()) * d_prod if need[2] else None
        d_nw = (d_prod * noise).sum().reshape(noise_weight.shape) if need[3] else None
        return d_out, d_demod, d_noise, d_nw, (d_bias if need[4] else None), None, None


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
    one-element tensor (read on the device: no host sync), bias (C,).
    Differentiable twice."""
    with count("ops.modconv_epilogue"):
        return ModconvEpilogue.apply(out, demod, noise, noise_weight, bias, slope, scale)


modconv_epilogue.launches = 0
modconv_epilogue.launches_bf16 = 0
