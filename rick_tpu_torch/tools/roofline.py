"""The least time the card could take for a kernel's work.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): HBM 3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores; 495 TFLOP/s TF32 on
the tensor cores.  A kernel's bound is the largest of its bytes (each input
read once, each output written once) over the memory rate, its CUDA-core
operations over the f32 rate, and its tensor-core operations over the TF32
rate.  K4 (`csrc/convt_blur_act.cu`) runs the transposed conv as 3xTF32, so
its conv counts three times (hi*hi, hi*lo, lo*hi) at the TF32 rate, and its
blur and epilogue at the f32 rate; so does K6 (`csrc/modconv_act.cu`) its
3x3 conv and its epilogue.  K7 (`csrc/filtered_lrelu.cu`) counts its FIR
passes at the least work they take (`filtered_lrelu_work`).

The launch floor: a kernel takes at least the device time of an empty
kernel launched with its grid on the same card (`rick_empty_launch`,
measured in the same run), which at a toy shape (K3-bf16 at 4x4, K1 at
(B, 512)) is far above what its bytes or operations take.  `bound` counts
it where the caller gives it.

K1 and K3 are bound by their bytes.  Their bf16 instantiations read bf16
(2 bytes an element) and write f32 (4), so `fused_bias_act_bytes` and
`modconv_epilogue_bytes` take the input's element size.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
TF32_PASSES = 3  # 3xTF32: each f32 product is three TF32 products


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
    """K1's bytes: x read (`x_bytes` an element), the f32 y written, the f32
    bias read."""
    return numel * (x_bytes + 4) + 4 * channels


def modconv_epilogue_bytes(batch: int, channels: int, hw: int, noise_batch: int, in_bytes: int = 4) -> int:
    """K3's bytes: out, demod, the noise maps and the noise weight read
    (`in_bytes` an element), the f32 bias read, the f32 y written."""
    out = batch * channels * hw
    return out * (in_bytes + 4) + in_bytes * (batch * channels + noise_batch * hw + 1) + 4 * channels


def modconv_act_work(n: int, cin: int, cout: int, h: int, w: int, noise_batch: int):
    """K6's (bytes, f32 operations, TF32 operations): x, s, the weights,
    demod, the noise maps, the noise weight and the bias read once, the
    output written once; the epilogue (4 operations per output) on the CUDA
    cores; the 3x3 conv (9 taps of Cin per output pixel and channel, as
    `convt_ops` counts per input pixel) as 3xTF32."""
    y = n * cout * h * w
    nbytes = 4 * (n * cin * h * w + n * cin + cout * cin * 9 + n * cout + noise_batch * h * w + 1 + cout + y)
    return nbytes, 4 * y, TF32_PASSES * convt_ops(n, cin, cout, h, w)


def filtered_lrelu_work(n: int, c: int, h_in: int, w_in: int, h_out: int, w_out: int, up: int, down: int,
                        taps_up: int, taps_down: int, padding) -> tuple:
    """K7's (bytes, f32 operations), from the arguments of its C entry point:
    x read once and y written once (the bias and filters are a few hundred
    bytes); per (n, c) plane the separable up passes, polyphase (taps_up / up
    multiply-adds per output: the x pass on the h_in input rows, the y pass
    on the whole M_h x M_w intermediate grid), the down passes at the kept
    positions only (taps_down per output: the x pass on the M_h rows, the y
    pass on the output), and 4 operations per intermediate sample for the
    leaky ReLU, gain and clamp."""
    px0, px1, py0, py1 = padding
    mh = h_in * up + py0 + py1 - taps_up + 1
    mw = w_in * up + px0 + px1 - taps_up + 1
    macs = (h_in * mw + mh * mw) * (taps_up // up) + (mh * w_out + h_out * w_out) * taps_down
    planes = n * c
    return 4 * planes * (h_in * w_in + h_out * w_out), planes * (2 * macs + 4 * mh * mw)
