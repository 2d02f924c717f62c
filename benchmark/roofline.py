"""The least time the card could take for a kernel's work, and the card's
peaks.  The arithmetic is a copy of the port's `tools/roofline.py`, kept here
so that a change to the program cannot move the yardstick.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): HBM 3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores; 495 TFLOP/s TF32 on
the tensor cores, the card's highest rate for f32 operands, which every
f32-faithful route (cuDNN f32 on the CUDA cores, 3xTF32) stays below.  A
kernel's bound is the largest of its bytes (each input read once, each
output written once) over the memory rate, its CUDA-core operations over
the f32 rate, and its tensor-core operations over the TF32 rate.

`launch_bound` gives the bound of one launch of the port's kernels from the
arguments of its C entry point, which carry the launch's shape.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
TF32_PASSES = 3  # 3xTF32: each f32 product is three TF32 products

# the port's kernels: C entry point -> (metric name, device kernel names)
KERNELS = {
    "rick_fused_bias_act": ("K1", ("fba_rows", "fba_lastdim")),
    "rick_fused_bias_act_bwd": ("K2", ("fba_bwd_rows", "fba_bwd_lastdim")),
    "rick_modconv_epilogue": ("K3", ("epi_rows",)),
    "rick_convt_blur_act_stage": ("K4", ("convt_blur_act_kernel",)),
    "rick_modconv_act": ("K6", ("modconv_act_kernel",)),
}


def bound(nbytes: float, f32_ops: float, tf32_ops: float = 0.0, launch_ms: float = 0.0):
    """(least ms, what bounds it: "bytes", "operations", or "launch" where
    the launch floor `launch_ms` is the largest term)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(f32_ops / PEAK_F32_FLOP_PER_S, tf32_ops / PEAK_TF32_FLOP_PER_S)
    ms = max(t_bytes, t_ops) * 1e3
    if launch_ms > ms:
        return launch_ms, "launch"
    return ms, ("bytes" if t_bytes >= t_ops else "operations")


def convt_ops(batch: int, cin: int, cout: int, h: int, w: int | None = None) -> int:
    """The transposed conv's operations (multiply-adds x 2): 9 taps of Cin
    per (input pixel, output channel)."""
    return 2 * batch * cin * cout * 9 * h * (h if w is None else w)


def fused_bias_act_bytes(numel: int, channels: int, x_bytes: int = 4) -> int:
    """K1's bytes: x read, the f32 y written, the f32 bias read."""
    return numel * (x_bytes + 4) + 4 * channels


def fused_bias_act_bwd_bytes(numel: int, channels: int, with_bias: bool) -> int:
    """K2's bytes: g and y read, the gradient written, the bias read if given."""
    return 4 * (3 * numel + (channels if with_bias else 0))


def modconv_epilogue_bytes(batch: int, channels: int, hw: int, noise_batch: int, in_bytes: int = 4) -> int:
    """K3's bytes: out, demod, the noise maps and the noise weight read, the
    f32 bias read, the f32 y written."""
    out = batch * channels * hw
    return out * (in_bytes + 4) + in_bytes * (batch * channels + noise_batch * hw + 1) + 4 * channels


def convt_blur_act_work(n: int, cin: int, cout: int, h: int, w: int, noise_batch: int):
    """K4's (bytes, f32 operations, TF32 operations): the input, the weights,
    demod, noise and bias read once, the output written once; the separable
    blur (4 + 4 taps per output) and the epilogue on the CUDA cores; the
    transposed conv as 3xTF32."""
    y = n * cout * 4 * h * w
    nbytes = 4 * (n * cin * h * w + cout * cin * 9 + n * cout + noise_batch * 4 * h * w + cout + y)
    return nbytes, 2 * 8 * y + 4 * y, TF32_PASSES * convt_ops(n, cin, cout, h, w)


def modconv_act_work(n: int, cin: int, cout: int, h: int, w: int, noise_batch: int):
    """K6's (bytes, f32 operations, TF32 operations): x, s, the weights,
    demod, the noise maps, the noise weight and the bias read once, the
    output written once; the epilogue (4 operations per output) on the CUDA
    cores; the 3x3 conv (9 taps of Cin per output pixel and channel, as
    `convt_ops` counts per input pixel) as 3xTF32."""
    y = n * cout * h * w
    nbytes = 4 * (n * cin * h * w + n * cin + cout * cin * 9 + n * cout + noise_batch * h * w + 1 + cout + y)
    return nbytes, 4 * y, TF32_PASSES * convt_ops(n, cin, cout, h, w)


def launch_bound(fn: str, args: tuple) -> float:
    """The bound in ms of one launch of the port's C entry point `fn` with
    the arguments `args` (see the signatures in the port's `ops/_build.py`)."""
    if fn == "rick_fused_bias_act":  # x, bias, y, n, C, inner, slope, scale, stream
        n, c = args[3], args[4]
        return bound(fused_bias_act_bytes(n, c), 3 * n)[0]
    if fn == "rick_fused_bias_act_bwd":  # g, y, bias|None, out, n, C, inner, slope, scale, stream
        n, c, with_bias = args[4], args[5], args[2] is not None
        return bound(fused_bias_act_bwd_bytes(n, c, with_bias), (3 if with_bias else 2) * n)[0]
    if fn == "rick_modconv_epilogue":  # out, demod, noise, nw, bias, y, B, C, HW, noise_batched, ...
        b, c, hw, batched = args[6], args[7], args[8], args[9]
        return bound(modconv_epilogue_bytes(b, c, hw, b if batched else 1), 6 * b * c * hw)[0]
    if fn == "rick_convt_blur_act_stage":  # xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, nb, ...
        n, cin, cout, h, w, batched = args[6:12]
        return bound(*convt_blur_act_work(n, cin, cout, h, w, n if batched else 1))[0]
    if fn == "rick_modconv_act":  # x, wt, s, demod, noise, nw, bias, y, N, Cin, Cout, H, W, noise_batched, ...
        n, cin, cout, h, w, batched = args[8:14]
        return bound(*modconv_act_work(n, cin, cout, h, w, n if batched else 1))[0]
    raise KeyError(fn)
