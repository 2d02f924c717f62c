"""StyleGAN3-T generator: Karras et al., "Alias-Free Generative Adversarial
Networks" (NeurIPS 2021), as NVlabs' `training/networks_stylegan3.py` builds
it under `--cfg=stylegan3-t`.

    z -> mapping (pixel norm, `n_mlp` EqualLinear + lrelu) -> w
    w -> SynthesisInput: Fourier features of a per-sample rotation and
         translation predicted from w, faded above the bandwidth, then a
         C x C linear layer                            (C, size0, size0)
      -> L0 ... L{n-1}: the modulated 3x3 conv with full padding (2), then
         the filtered leaky ReLU (bias, zero-insert up, FIR, lrelu * sqrt 2,
         clamp, FIR, decimate), which crops the margin back
      -> ToRGB: 1x1 modulated conv without demodulation, bias, clamp
      -> * output_scale

Every layer's channels, map size, sampling rate, cutoff, transition band,
up and down factors, filter taps and padding come from the geometric
schedule of `Generator3Config.layers()`; the filters are Kaiser low-passes
designed as `scipy.signal.firwin` designs them (`kaiser_lowpass`, numpy).
The state dict has NVlabs' names (`mapping.fc{i}.*`, `mapping.w_avg`,
`synthesis.input.{weight,affine.*,freqs,phases}`,
`synthesis.L{i}_{size}_{ch}.{weight,bias,magnitude_ema,affine.*}`); the
filters and the input's identity `transform` are computed by the
constructor and kept out of it (`ckpt.generator3_state_dict_from_nvlabs`
drops them from an NVlabs state dict).

The modulated conv is NVlabs' `modulated_conv2d` through the identity

    y = demod[b,o] * conv(x * s'[b,i], w_n)    s' = s_n * input_gain

with w_n the weight over its RMS per output channel, s_n the styles over
their RMS over the whole batch, demod = rsqrt(sum_i s_n^2 sum_kk w_n^2 +
1e-8) and input_gain = magnitude_ema ** -1/2.  `fast=False` runs it as
`F.conv2d` with padding 2, scaled by demod afterwards, and the filtered
leaky ReLU as `ops.filtered_lrelu`: differentiable by autograd.
`fast=True` (generation) sends each 3x3 conv through `ops.modconv_act`
(K6: padding 1 on an input padded by 1, demod, the layer's bias, a zero
noise, slope 1, gain 1) and each filtered leaky ReLU but ToRGB's through
`ops.filtered_lrelu_act` (K7), forward only; on a CPU tensor those are
their plain versions.  Only float32 is computed.  There is no per-layer
noise: `layer_noise` gives none and `num_layers` is 0.

Spans (`utils/trace.py`): `sg3.input` around the input, `sg3.modconv` around
each layer's affine and modulated conv, `sg3.filtered_lrelu` around each
filtered leaky ReLU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rick_tpu_torch.nn.blocks import EqualLinear, pixel_norm
from rick_tpu_torch.ops import filtered_lrelu, filtered_lrelu_act, modconv_act
from rick_tpu_torch.utils.trace import span

SQRT2 = math.sqrt(2.0)


def kaiser_lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray:
    """`scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)` in float64:
    the windowed sinc of the low-pass at `cutoff`, under the Kaiser window
    whose beta meets the attenuation of a transition band `width` wide,
    scaled to unit gain at DC."""
    nyq = 0.5 * fs
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    c = cutoff / nyq
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


@dataclass(frozen=True)
class Layer3:
    """One synthesis layer's schedule, as NVlabs' `SynthesisLayer` derives it."""

    name: str
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    is_torgb: bool
    kernel: int  # conv taps: 3, 1 for ToRGB
    tmp_sampling_rate: int  # the leaky ReLU's rate
    up: int
    down: int
    up_taps: int  # 1: no filter
    down_taps: int
    padding: Tuple[int, int, int, int]  # px0, px1, py0, py1 of the up pass


@dataclass(frozen=True)
class Generator3Config:
    size: int = 256
    style_dim: int = 512  # z_dim = w_dim
    n_mlp: int = 2
    lr_mlp: float = 0.01
    channel_base: int = 16384
    channel_max: int = 512
    synthesis_layers: int = 14  # excluding the input and ToRGB
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2**2.1
    last_stopband_rel: float = 2**0.3
    margin_size: int = 10
    filter_size: int = 6
    lrelu_upsampling: int = 2
    conv_clamp: float = 256.0
    output_scale: float = 0.25

    def schedule(self):
        """(cutoffs, stopbands, sampling rates, half widths, sizes, channels)
        of the input (index 0) and each layer, float64, as NVlabs'
        `SynthesisNetwork.__init__` computes them."""
        n = self.synthesis_layers
        last_cutoff = self.size / 2
        last_stopband = last_cutoff * self.last_stopband_rel
        exponents = np.minimum(np.arange(n + 1) / (n - self.num_critical), 1)
        cutoffs = self.first_cutoff * (last_cutoff / self.first_cutoff) ** exponents
        stopbands = self.first_stopband * (last_stopband / self.first_stopband) ** exponents
        rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, self.size))))
        half_widths = np.maximum(stopbands, rates / 2) - cutoffs
        sizes = rates + self.margin_size * 2
        sizes[-2:] = self.size
        channels = np.rint(np.minimum((self.channel_base / 2) / cutoffs, self.channel_max))
        channels[-1] = 3
        return cutoffs, stopbands, rates, half_widths, sizes, channels

    def layers(self) -> List[Layer3]:
        cutoffs, _, rates, half_widths, sizes, channels = self.schedule()
        n = self.synthesis_layers
        out = []
        for idx in range(n + 1):
            prev = max(idx - 1, 0)
            torgb = idx == n
            kernel = 1 if torgb else 3
            tmp = int(max(rates[prev], rates[idx]) * (1 if torgb else self.lrelu_upsampling))
            up, down = int(np.rint(tmp / rates[prev])), int(np.rint(tmp / rates[idx]))
            up_taps = self.filter_size * up if up > 1 and not torgb else 1
            down_taps = self.filter_size * down if down > 1 and not torgb else 1
            in_size, out_size = int(sizes[prev]), int(sizes[idx])
            pad_total = (out_size - 1) * down + 1 - (in_size + kernel - 1) * up + up_taps + down_taps - 2
            pad_lo = (pad_total + up) // 2  # the symmetric interpretation (NVlabs' Appendix C.3)
            pad_hi = pad_total - pad_lo
            out.append(Layer3(
                name=f"L{idx}_{out_size}_{int(channels[idx])}", in_channels=int(channels[prev]),
                out_channels=int(channels[idx]), in_size=in_size, out_size=out_size,
                in_sampling_rate=int(rates[prev]), out_sampling_rate=int(rates[idx]), in_cutoff=float(cutoffs[prev]),
                out_cutoff=float(cutoffs[idx]), in_half_width=float(half_widths[prev]),
                out_half_width=float(half_widths[idx]), is_torgb=torgb, kernel=kernel, tmp_sampling_rate=tmp,
                up=up, down=down, up_taps=up_taps, down_taps=down_taps, padding=(pad_lo, pad_hi, pad_lo, pad_hi)))
        return out


def _filter(taps: int, cutoff: float, half_width: float, fs: int, device) -> Optional[torch.Tensor]:
    if taps == 1:
        return None
    return torch.as_tensor(kaiser_lowpass(taps, cutoff, half_width * 2, fs), dtype=torch.float32, device=device)


class MappingNetwork3(nn.Module):
    """Pixel norm, then `n_mlp` EqualLinear with leaky ReLU (K1 on the card)."""

    def __init__(self, cfg: Generator3Config, *, rng: torch.Generator, device=None):
        super().__init__()
        self.n_mlp = cfg.n_mlp
        for i in range(cfg.n_mlp):
            setattr(self, f"fc{i}", EqualLinear(cfg.style_dim, cfg.style_dim, lr_mul=cfg.lr_mlp,
                                                activation="fused_lrelu", rng=rng, device=device))
        self.register_buffer("w_avg", torch.zeros(cfg.style_dim, device=device))  # for truncation; unused here

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(z)
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x


class SynthesisInput(nn.Module):
    """Fourier features: `channels` frequencies inside `bandwidth`, rotated
    and shifted per sample by the affine of w, sampled on a size x size grid
    at `sampling_rate`, then a channels x channels linear layer."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float, bandwidth: float, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = float(sampling_rate), float(bandwidth)
        freqs = torch.randn((channels, 2), generator=rng, device=device)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bandwidth
        phases = torch.rand((channels,), generator=rng, device=device) - 0.5
        self.weight = nn.Parameter(torch.randn((channels, channels), generator=rng, device=device))
        self.affine = EqualLinear(w_dim, 4, rng=rng, device=device)
        with torch.no_grad():
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer("transform", torch.eye(3, device=device), persistent=False)
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        with span("sg3.input"):
            t = self.affine(w)  # (r_c, r_s, t_x, t_y)
            t = t / t[:, :2].norm(dim=1, keepdim=True)
            c, s, tx, ty = t.unbind(1)
            zero, one = torch.zeros_like(c), torch.ones_like(c)
            m_r = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], 1).reshape(-1, 3, 3)
            m_t = torch.stack([one, zero, -tx, zero, one, -ty, zero, zero, one], 1).reshape(-1, 3, 3)
            transforms = m_r @ m_t @ self.transform  # rotate, then translate, then the user's transform
            phases = self.phases + (self.freqs @ transforms[:, :2, 2:]).squeeze(2)  # (B, C)
            freqs = self.freqs @ transforms[:, :2, :2]  # (B, C, 2)
            amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                          / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
            # affine_grid's sample points (align_corners=False) at the sampling rate
            grid = torch.arange(self.size, device=w.device, dtype=torch.float32) + 0.5 - self.size / 2
            grid = grid / self.sampling_rate
            x = (grid[None, None, :, None] * freqs[:, None, None, :, 0]
                 + grid[None, :, None, None] * freqs[:, None, None, :, 1])  # (B, H, W, C)
            x = torch.sin((x + phases[:, None, None, :]) * (2 * math.pi)) * amplitudes[:, None, None, :]
            x = x @ (self.weight / math.sqrt(self.channels)).t()
            return x.permute(0, 3, 1, 2).contiguous()


class SynthesisLayer3(nn.Module):
    """Modulated conv and filtered leaky ReLU of one `Layer3`."""

    def __init__(self, spec: Layer3, w_dim: int, conv_clamp: float, *, rng: torch.Generator, device=None):
        super().__init__()
        self.spec = spec
        self.conv_clamp = conv_clamp
        self.affine = EqualLinear(w_dim, spec.in_channels, bias_init=1.0, rng=rng, device=device)
        k = spec.kernel
        self.weight = nn.Parameter(torch.randn((spec.out_channels, spec.in_channels, k, k), generator=rng,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(spec.out_channels, device=device))
        self.register_buffer("magnitude_ema", torch.ones((), device=device))
        self.register_buffer("up_filter", _filter(spec.up_taps, spec.in_cutoff, spec.in_half_width,
                                                  spec.tmp_sampling_rate, device), persistent=False)
        self.register_buffer("down_filter", _filter(spec.down_taps, spec.out_cutoff, spec.out_half_width,
                                                    spec.tmp_sampling_rate, device), persistent=False)

    def modulated_conv(self, x: torch.Tensor, w: torch.Tensor,
                       fast: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the conv's output, the bias still to add: None where K6 added it)."""
        s = self.affine(w)
        input_gain = self.magnitude_ema.rsqrt()
        if self.spec.is_torgb:
            s = s * (1 / math.sqrt(self.spec.in_channels * self.spec.kernel**2))
            return F.conv2d(x * (s * input_gain)[:, :, None, None], self.weight), self.bias
        weight = self.weight * self.weight.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()  # over the whole batch, as NVlabs
        demod = torch.rsqrt(s.square() @ weight.square().sum(dim=(2, 3)).t() + 1e-8)
        s = s * input_gain
        if fast:
            side = x.shape[2] + 2
            noise = torch.zeros((1, 1, side, side), device=x.device)
            return modconv_act(F.pad(x, (1, 1, 1, 1)), s, weight, demod, noise, noise.new_zeros(1), self.bias,
                               slope=1.0, gain=1.0), None
        out = F.conv2d(x * s[:, :, None, None], weight, padding=self.spec.kernel - 1)
        return out * demod[:, :, None, None], self.bias

    def forward(self, x: torch.Tensor, w: torch.Tensor, *, fast: bool = False) -> torch.Tensor:
        spec = self.spec
        with span("sg3.modconv"):
            x, bias = self.modulated_conv(x, w, fast)
        with span("sg3.filtered_lrelu"):
            if fast and not spec.is_torgb:
                return filtered_lrelu_act(x, self.up_filter, self.down_filter, bias, spec.up, spec.down,
                                          spec.padding, gain=SQRT2, slope=0.2, clamp=self.conv_clamp)
            return filtered_lrelu(x, self.up_filter, self.down_filter, bias, spec.up, spec.down, spec.padding,
                                  gain=1.0 if spec.is_torgb else SQRT2, slope=1.0 if spec.is_torgb else 0.2,
                                  clamp=self.conv_clamp)


class SynthesisNetwork3(nn.Module):
    def __init__(self, cfg: Generator3Config, *, rng: torch.Generator, device=None):
        super().__init__()
        cutoffs, _, rates, _, sizes, channels = cfg.schedule()
        self.output_scale = cfg.output_scale
        self.input = SynthesisInput(cfg.style_dim, int(channels[0]), int(sizes[0]), rates[0], cutoffs[0], rng=rng,
                                    device=device)
        self.layer_names = []
        for spec in cfg.layers():
            setattr(self, spec.name, SynthesisLayer3(spec, cfg.style_dim, cfg.conv_clamp, rng=rng, device=device))
            self.layer_names.append(spec.name)

    def forward(self, w: torch.Tensor, *, fast: bool = False) -> torch.Tensor:
        """The image (B, 3, size, size) of w (B, w_dim), every layer taking
        the same w."""
        x = self.input(w)
        for name in self.layer_names:
            x = getattr(self, name)(x, w, fast=fast)
        return x * self.output_scale


class Generator3(nn.Module):
    """StyleGAN3-T behind the interface the Evaluator calls on a G:
    `g([z], rng=, noise=, dtype=, fast=) -> (image, None)`, `layer_noise`,
    `num_layers` (0: no per-layer noise) and `device`.  Weights are drawn
    from `rng` with NVlabs' initial distributions."""

    num_layers = 0

    def __init__(self, cfg: Generator3Config = Generator3Config(), *, rng: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork3(cfg, rng=rng, device=device)
        self.synthesis = SynthesisNetwork3(cfg, rng=rng, device=device)

    @property
    def device(self) -> torch.device:
        return self.synthesis.input.weight.device

    def layer_noise(self, batch: int, rng: Optional[torch.Generator], noise) -> List[torch.Tensor]:
        return []

    def forward(self, styles: Sequence[torch.Tensor], *, rng: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None, dtype: torch.dtype = torch.float32,
                fast: bool = False):
        """(image, None) of the latents styles[0] (B, z_dim).  `rng` is
        unused (nothing is drawn); `noise` must be empty."""
        if dtype != torch.float32:
            raise ValueError(f"Generator3 computes float32 only, not {dtype}")
        if len(styles) != 1:
            raise ValueError("Generator3 takes one latent batch: it has no style mixing")
        if noise:
            raise ValueError("Generator3 has no per-layer noise")
        return self.synthesis(self.mapping(styles[0]), fast=fast), None
