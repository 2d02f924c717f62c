"""A 2-D convolution whose gradients are cheap to differentiate again, for
upfirdn2d.

R1 and path length differentiate through every convolution of D and G
twice.  PyTorch's own double backward of a convolution computes the weight
term of the second derivative even for a weight that needs no gradient, as
one more convolution in which the first gradient plays the filter.  For
upfirdn2d, which filters every channel as a batch row of one channel with
a fixed FIR kernel, that filter is as large as the feature map (257 x 257,
256 "channels" at the top of the 256px D) and cuDNN runs it as an "indexed"
implicit GEMM that takes most of the R1 phase's device time
(`python -m rick_tpu_torch.tools.ab_resample_conv` times both sides on a GPU
and profiles the slow one).  Here the weight gradient is a Function of its own, `_ConvGradWeight`, taken
only where the weight needs it and computed by the backend's weight-gradient
kernel (`aten.convolution_backward`), and the derivatives of each gradient
are again ordinary convolutions of the same shape, so every order of
derivative runs on the forward, data-gradient and weight-gradient kernels.
The math is the convolution's.  G's and D's own convolutions stay on
`F.conv2d`: their batch is 2, so PyTorch's weight term is cheap there, and a
Python Function around each would cost host time in every phase.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Pair = Tuple[int, int]


def _data_grad_output_padding(transpose: bool, x_shape, y_shape, w_shape, stride: Pair) -> Pair:
    """Output padding of the transposed convolution that maps an output of
    shape y_shape back onto an input of shape x_shape (0 when the forward
    convolution is itself transposed: its data gradient is a plain one)."""
    if transpose:
        return (0, 0)
    return tuple(x_shape[i + 2] - (y_shape[i + 2] - 1) * stride[i] - w_shape[i + 2] for i in range(2))


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, transpose: bool, stride: Pair, output_padding: Pair):
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
            op = _data_grad_output_padding(transpose, x.shape, gy.shape, w.shape, stride)
            gx = _Conv.apply(gy, w, not transpose, stride, op)
        if ctx.needs_input_grad[1]:
            gw = _ConvGradWeight.apply(gy, x, w, *ctx.conf)
        return gx, gw, None, None, None


class _ConvGradWeight(torch.autograd.Function):
    """gw(gy, x) = d<conv(x, w), gy>/dw; bilinear in (gy, x)."""

    @staticmethod
    def forward(ctx, gy, x, w, transpose: bool, stride: Pair, output_padding: Pair):
        ctx.save_for_backward(gy, x)
        ctx.conf = (transpose, stride, output_padding)
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, stride, (0, 0), (1, 1), transpose, output_padding, 1, [False, True, False],
        )[1]

    @staticmethod
    def backward(ctx, ggw):
        # <gw, ggw> = <conv(x, ggw), gy>: its derivative in gy is conv(x, ggw),
        # in x the data gradient of that convolution at gy
        gy, x = ctx.saved_tensors
        transpose, stride, _ = ctx.conf
        g_gy = g_x = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(x, ggw, *ctx.conf)
        if ctx.needs_input_grad[1]:
            op = _data_grad_output_padding(transpose, x.shape, gy.shape, ggw.shape, stride)
            g_x = _Conv.apply(gy, ggw, not transpose, stride, op)
        return g_gy, g_x, None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: Pair) -> torch.Tensor:
    """`F.conv2d(x, weight, stride=stride)` (no bias, padding 0, dilation 1,
    one group, as upfirdn2d calls it), differentiable to any order through
    convolutions of the same shape."""
    return _Conv.apply(x, weight, False, tuple(stride), (0, 0))
