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
chain is differentiable by autograd to any order.  There is no CUDA kernel
behind it: on the card it runs the same chain, so a (N, C) slab's largest
upsampled grid (layer 10 of StyleGAN3-T at 256px: 600 x 600 per channel)
is split into blocks of channels of at most `GRID_ELEMS` elements each.
Inside `utils.trace.recording()` each call is counted under
`ops.filtered_lrelu`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from rick_tpu_torch.ops.resample import upfirdn2d_general
from rick_tpu_torch.utils.trace import count

SQRT2 = math.sqrt(2.0)
GRID_ELEMS = 1 << 30  # elements of one block's upsampled grid (4 GiB in f32)


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
