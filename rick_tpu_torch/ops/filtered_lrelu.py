"""StyleGAN3's filtered leaky ReLU, as a plain chain over `ops.resample`.

    y = down_fd( clamp( lrelu( up_fu( pad( x + b ) ), slope ) * gain, +-clamp ) )

with NVlabs' semantics (`torch_utils/ops/filtered_lrelu.py::_filtered_lrelu_ref`):
the bias is added, the map is zero-inserted by `up`, padded by `padding`
(px0, px1, py0, py1; negative crops) and filtered by the separable 1-D
filter `fu` with gain up**2, leaky ReLU'd, scaled by `gain` and clamped,
then filtered by the separable `fd` and decimated by `down`.  A filter of
None is the identity (its factor is then 1).

    out = (in * up + px0 + px1 - (len(fu) - 1) - (len(fd) - 1) + down - 1) // down

Every filter pass is one 1-D `upfirdn2d_general` along one axis: the y
passes first, then the x passes (the two orders are the same sums).  The
chain is differentiable by autograd to any order.  `filtered_lrelu` runs
it on any device, so a (N, C) slab's largest upsampled grid (layer 10 of
StyleGAN3-T at 256px: 600 x 600 per channel) is split into blocks of
channels of at most `GRID_ELEMS` elements each.  Inside
`utils.trace.recording()` each call is counted under `ops.filtered_lrelu`.

`filtered_lrelu_act` is the same function as one CUDA kernel (K7,
`csrc/filtered_lrelu.cu`) for generation: forward only, float32 only, up 2
or 4 with 6 * up taps, down 2 with 12 taps.  It launches the kernel for
CUDA tensors and takes `filtered_lrelu_ref` for CPU tensors, raises on what
the kernel does not take, counts its launches in
`filtered_lrelu_act.launches` and its calls under `ops.filtered_lrelu_act`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from rick_tpu_torch.ops import _build
from rick_tpu_torch.ops.kernels import _require, check_cuda, forbid_autograd
from rick_tpu_torch.ops.resample import upfirdn2d_general
from rick_tpu_torch.utils.trace import count

SQRT2 = math.sqrt(2.0)
GRID_ELEMS = 1 << 30  # elements of one block's upsampled grid (4 GiB in f32)
ACT_UPS = (2, 4)  # K7's up factors: 6 taps a phase
ACT_DOWN, ACT_DOWN_TAPS = 2, 12


def _passes(x: torch.Tensor, f: Optional[torch.Tensor], up: int, down: int, pad: Sequence[int],
            gain: float = 1.0) -> torch.Tensor:
    """upfirdn2d with the separable filter outer(f, f) * gain**2: a y pass,
    then an x pass; nothing where it is the identity."""
    px0, px1, py0, py1 = pad
    if f is None:
        if up == 1 and down == 1 and not any(pad):
            return x
        f = torch.ones(1, device=x.device)
    f = f.to(x.dtype) * gain
    x = upfirdn2d_general(x, f[:, None], 1, up, 1, down, 0, 0, py0, py1)
    return upfirdn2d_general(x, f[None, :], up, 1, down, 1, px0, px1, 0, 0)


def filtered_lrelu_ref(x: torch.Tensor, fu: Optional[torch.Tensor], fd: Optional[torch.Tensor],
                       b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                       padding: Sequence[int] = (0, 0, 0, 0), gain: float = SQRT2, slope: float = 0.2,
                       clamp: Optional[float] = None) -> torch.Tensor:
    """The unblocked chain: x (N, C, H, W), 1-D filters `fu`, `fd` (or None),
    bias `b` (C,) or None."""
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1)
    x = _passes(x, fu, up, 1, padding, gain=up)
    x = F.leaky_relu(x, slope) * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return _passes(x, fd, 1, down, (0, 0, 0, 0))


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor], fd: Optional[torch.Tensor],
                   b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                   padding: Sequence[int] = (0, 0, 0, 0), gain: float = SQRT2, slope: float = 0.2,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """`filtered_lrelu_ref` in blocks of channels whose upsampled grid holds
    at most `GRID_ELEMS` elements (one block where it fits)."""
    with count("ops.filtered_lrelu"):
        n, c, h, w = x.shape
        px0, px1, py0, py1 = padding
        per_channel = n * (h * up + py0 + py1) * (w * up + px0 + px1)
        block = max(1, GRID_ELEMS // max(per_channel, 1))
        kw = dict(up=up, down=down, padding=padding, gain=gain, slope=slope, clamp=clamp)
        if block >= c:
            return filtered_lrelu_ref(x, fu, fd, b, **kw)
        biases = [None] * -(-c // block) if b is None else b.split(block)
        return torch.cat([filtered_lrelu_ref(xc, fu, fd, bc, **kw) for xc, bc in zip(x.split(block, dim=1), biases)],
                         dim=1)


def output_size(n: int, up: int, down: int, taps_up: int, taps_down: int, pad0: int, pad1: int) -> int:
    """The output length along an axis of n input samples."""
    return (n * up + pad0 + pad1 - (taps_up - 1) - (taps_down - 1) + down - 1) // down


def filtered_lrelu_act(x: torch.Tensor, fu: torch.Tensor, fd: torch.Tensor, b: Optional[torch.Tensor] = None,
                       up: int = 2, down: int = 2, padding: Sequence[int] = (0, 0, 0, 0), gain: float = SQRT2,
                       slope: float = 0.2, clamp: Optional[float] = None) -> torch.Tensor:
    """`filtered_lrelu_ref` in one kernel (K7) on a CUDA tensor, the plain
    chain on a CPU tensor.  x (N, C, H, W) contiguous float32; fu (6 up,),
    fd (12,), b (C,) or None.  Forward only."""
    name = "filtered_lrelu_act"
    with count("ops.filtered_lrelu_act"):
        _require(up in ACT_UPS and down == ACT_DOWN, f"{name}: up {up}, down {down}: the kernel takes up "
                 f"{' or '.join(map(str, ACT_UPS))} and down {ACT_DOWN}")
        _require(x.ndim == 4, f"{name}: x must be 4-D, got {tuple(x.shape)}")
        n, c, h, w = x.shape
        _require(tuple(fu.shape) == (6 * up,), f"{name}: fu {tuple(fu.shape)} != ({6 * up},)")
        _require(tuple(fd.shape) == (ACT_DOWN_TAPS,), f"{name}: fd {tuple(fd.shape)} != ({ACT_DOWN_TAPS},)")
        _require(b is None or tuple(b.shape) == (c,), f"{name}: b {None if b is None else tuple(b.shape)} != ({c},)")
        _require(len(padding) == 4, f"{name}: padding {tuple(padding)} is not (px0, px1, py0, py1)")
        px0, px1, py0, py1 = (int(v) for v in padding)
        sizes = (output_size(h, up, down, 6 * up, ACT_DOWN_TAPS, py0, py1),
                 output_size(w, up, down, 6 * up, ACT_DOWN_TAPS, px0, px1))
        _require(min(sizes) > 0, f"{name}: padding {tuple(padding)} leaves no output of a {h} x {w} map")
        tensors = dict(x=x, fu=fu, fd=fd) if b is None else dict(x=x, fu=fu, fd=fd, b=b)
        check_cuda(name, x.device, torch.float32, **tensors)
        forbid_autograd(name, **tensors)
        kw = dict(up=up, down=down, padding=padding, gain=gain, slope=slope, clamp=clamp)
        if x.device.type == "cpu":
            return filtered_lrelu_ref(x, fu, fd, b, **kw)
        _require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
        y = torch.empty((n, c, *sizes), device=x.device, dtype=torch.float32)
        if y.numel() == 0:
            return y
        code = _build.lib().rick_filtered_lrelu(
            x.data_ptr(), None if b is None else b.data_ptr(), fu.data_ptr(), fd.data_ptr(), y.data_ptr(), n, c, h, w,
            *sizes, up, down, 6 * up, ACT_DOWN_TAPS, px0, px1, py0, py1, float(gain), float(slope),
            math.inf if clamp is None else float(clamp), _build.stream_ptr(x.device),
        )
        _build.check(code, name)
        filtered_lrelu_act.launches += 1
        return y


filtered_lrelu_act.launches = 0
