"""Plain StyleGAN3-T generator in PyTorch, the yardstick the benchmark holds
the port's `Generator3` to, and the StyleGAN2 discriminator NVlabs trains it
with.

The generator follows NVlabs' `training/networks_stylegan3.py` under
`--cfg=stylegan3-t` (`MappingNetwork`, `SynthesisInput`, `SynthesisLayer`,
`SynthesisNetwork`, `modulated_conv2d`) and the reference paths of its ops
(`_filtered_lrelu_ref`, `_upfirdn2d_ref`, `_bias_act_ref`): the geometric
schedule of cutoffs, stopbands, sampling rates and channels, Kaiser filters
designed as `scipy.signal.firwin` designs them (written out in numpy), the
Fourier input through `affine_grid`, each 3x3 conv with padding 2, and the
filtered leaky ReLU with zero insertion on both axes and the separable FIR
as grouped convolutions.  Parameter and buffer names are NVlabs', so one
state dict loads into this model and into the program's.  It imports
nothing of the program: it is a frozen copy of the arithmetic, so that a
later change to the program cannot move it.

Departures from NVlabs, none of which changes the function computed:

- everything runs in float32, where NVlabs runs the four highest-resolution
  layers in fp16 on a GPU; the clamp at 256 is kept;
- NVlabs' batch-wide style RMS is kept: it cancels in demodulation up to
  demodulation's 1e-8, so a block of draws other than the program's chunk
  moves the result by rounding alone;
- the modulated conv is demod * conv(x * s', w_n) with one weight for the
  batch, where NVlabs convolves with per-sample weights in one grouped
  convolution: the convolution is linear in both scalings;
- the filtered leaky ReLU runs in blocks of channels, so that a chunk of
  100 images fits on one card (layer 10's zero-inserted grid is 585 x 585
  per channel); each channel's arithmetic is as unblocked;
- the filters and the input's `transform` are buffers kept out of the
  state dict (NVlabs keeps them in it): they are computed here;
- no truncation, no `update_emas`, no class conditioning, no per-layer
  noise (`num_layers` 0).

The discriminator is the benchmark's StyleGAN2 D (`reference/stylegan2.py`)
at NVlabs' 256px sizes: channel_base 16384 is channel_multiplier 1, and the
minibatch-stddev group 4.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import stylegan2

SQRT2 = math.sqrt(2.0)
GRID_ELEMS = 1 << 30  # elements of one block's zero-inserted grid in the filtered leaky ReLU


def firwin(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray:
    """`scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)`: a Kaiser
    window of the beta that `kaiser_beta(kaiser_atten(...))` gives, over the
    ideal low-pass, scaled to unit gain at DC."""
    nyq = 0.5 * fs
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps) - alpha
    right = cutoff / nyq
    h = right * np.sinc(right * m)
    n = np.arange(numtaps)
    h *= np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2)) / np.i0(beta)
    return h / np.sum(h)


def bias_act(x, b=None, act="linear", alpha=0.2, gain=1.0, clamp=None):
    if b is not None:
        x = x + b.reshape([-1 if i == 1 else 1 for i in range(x.ndim)])
    if act == "lrelu":
        x = F.leaky_relu(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def upfirdn2d(x, f, up=1, down=1, padding=(0, 0, 0, 0), gain=1):
    """NVlabs' `_upfirdn2d_ref` with a 1-D (separable) filter or None;
    padding (px0, px1, py0, py1), negative crops."""
    if f is None:
        f = torch.ones([1], dtype=torch.float32, device=x.device)
    batch, ch, h, w = x.shape
    px0, px1, py0, py1 = padding
    x = x.reshape([batch, ch, h, 1, w, 1])
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape([batch, ch, h * up, w * up])
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = (f * gain ** 0.5).to(x.dtype).flip(0)
    f = f[None, None].repeat([ch, 1, 1])
    x = F.conv2d(x, f.unsqueeze(2), groups=ch)
    x = F.conv2d(x, f.unsqueeze(3), groups=ch)
    return x[:, :, ::down, ::down]


def filtered_lrelu(x, fu, fd, b, up, down, padding, gain, slope, clamp):
    """NVlabs' `_filtered_lrelu_ref`, in blocks of channels."""
    n, c, h, w = x.shape
    per_channel = n * (h * up + padding[2] + padding[3]) * (w * up + padding[0] + padding[1])
    block = max(1, GRID_ELEMS // per_channel)
    out = []
    for c0 in range(0, c, block):
        y = bias_act(x[:, c0: c0 + block], b[c0: c0 + block])
        y = upfirdn2d(y, fu, up=up, padding=padding, gain=up**2)
        y = bias_act(y, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
        out.append(upfirdn2d(y, fd, down=down))
    return torch.cat(out, dim=1)


class FullyConnectedLayer(nn.Module):
    def __init__(self, in_features, out_features, activation="linear", lr_multiplier=1.0):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.empty([out_features, in_features]))
        self.bias = nn.Parameter(torch.empty([out_features]))
        self.weight_gain = lr_multiplier / np.sqrt(in_features)
        self.bias_gain = lr_multiplier

    def forward(self, x):
        w = self.weight * self.weight_gain
        b = self.bias * self.bias_gain
        if self.activation == "linear":
            return torch.addmm(b.unsqueeze(0), x, w.t())
        return bias_act(x.matmul(w.t()), b, act="lrelu", gain=SQRT2)


class MappingNetwork(nn.Module):
    def __init__(self, z_dim, w_dim, num_layers, lr_multiplier):
        super().__init__()
        self.num_layers = num_layers
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(z_dim if idx == 0 else w_dim, w_dim, "lrelu", lr_multiplier))
        self.register_buffer("w_avg", torch.empty([w_dim]))

    def forward(self, z):
        x = z * (z.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        return x


class SynthesisInput(nn.Module):
    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = float(sampling_rate), float(bandwidth)
        self.weight = nn.Parameter(torch.empty([channels, channels]))
        self.affine = FullyConnectedLayer(w_dim, 4)
        self.register_buffer("transform", torch.eye(3, 3), persistent=False)
        self.register_buffer("freqs", torch.empty([channels, 2]))
        self.register_buffer("phases", torch.empty([channels]))

    def forward(self, w):
        transforms = self.transform.unsqueeze(0)
        freqs, phases = self.freqs.unsqueeze(0), self.phases.unsqueeze(0)
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
        m_r[:, 0, 0] = t[:, 0]
        m_r[:, 0, 1] = -t[:, 1]
        m_r[:, 1, 0] = t[:, 1]
        m_r[:, 1, 1] = t[:, 0]
        m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
        m_t[:, 0, 2] = -t[:, 2]
        m_t[:, 1, 2] = -t[:, 3]
        transforms = m_r @ m_t @ transforms
        phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth) / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = 0.5 * self.size / self.sampling_rate
        theta[1, 1] = 0.5 * self.size / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, self.size, self.size], align_corners=False)
        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = x + phases.unsqueeze(1).unsqueeze(2)
        x = torch.sin(x * (np.pi * 2))
        x = x * amplitudes.unsqueeze(1).unsqueeze(2)
        x = x @ (self.weight / np.sqrt(self.channels)).t()
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    def __init__(self, w_dim, is_torgb, in_channels, out_channels, in_size, out_size, in_sampling_rate,
                 out_sampling_rate, in_cutoff, out_cutoff, in_half_width, out_half_width, filter_size,
                 lrelu_upsampling, conv_clamp):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels = in_channels
        self.conv_kernel = 1 if is_torgb else 3
        self.conv_clamp = conv_clamp
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else lrelu_upsampling)
        self.affine = FullyConnectedLayer(w_dim, in_channels)
        self.weight = nn.Parameter(torch.empty([out_channels, in_channels, self.conv_kernel, self.conv_kernel]))
        self.bias = nn.Parameter(torch.empty([out_channels]))
        self.register_buffer("magnitude_ema", torch.empty([]))
        self.up_factor = int(np.rint(tmp_rate / in_sampling_rate))
        self.up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        self.register_buffer("up_filter", self.design_lowpass_filter(
            self.up_taps, in_cutoff, in_half_width * 2, tmp_rate), persistent=False)
        self.down_factor = int(np.rint(tmp_rate / out_sampling_rate))
        self.down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        self.register_buffer("down_filter", self.design_lowpass_filter(
            self.down_taps, out_cutoff, out_half_width * 2, tmp_rate), persistent=False)
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total -= (in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]

    @staticmethod
    def design_lowpass_filter(numtaps, cutoff, width, fs):
        if numtaps == 1:
            return None
        return torch.as_tensor(firwin(numtaps, cutoff, width, fs), dtype=torch.float32)

    def forward(self, x, w):
        input_gain = self.magnitude_ema.rsqrt()
        s = self.affine(w)
        weight = self.weight
        if self.is_torgb:
            s = s * (1 / np.sqrt(self.in_channels * self.conv_kernel**2))
            x = F.conv2d(x * (s * input_gain)[:, :, None, None], weight)
        else:
            weight = weight * weight.square().mean([1, 2, 3], keepdim=True).rsqrt()
            s = s * s.square().mean().rsqrt()
            dcoefs = (s.square() @ weight.square().sum(dim=[2, 3]).t() + 1e-8).rsqrt()
            x = F.conv2d(x * (s * input_gain)[:, :, None, None], weight, padding=self.conv_kernel - 1)
            x = x * dcoefs[:, :, None, None]
        return filtered_lrelu(x, self.up_filter, self.down_filter, self.bias, self.up_factor, self.down_factor,
                              self.padding, gain=1.0 if self.is_torgb else SQRT2,
                              slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        n, res = cfg["synthesis_layers"], cfg["size"]
        self.output_scale = cfg["output_scale"]
        last_cutoff = res / 2
        last_stopband = last_cutoff * cfg["last_stopband_rel"]
        exponents = np.minimum(np.arange(n + 1) / (n - cfg["num_critical"]), 1)
        cutoffs = cfg["first_cutoff"] * (last_cutoff / cfg["first_cutoff"]) ** exponents
        stopbands = cfg["first_stopband"] * (last_stopband / cfg["first_stopband"]) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + cfg["margin_size"] * 2
        sizes[-2:] = res
        channels = np.rint(np.minimum((cfg["channel_base"] / 2) / cutoffs, cfg["channel_max"]))
        channels[-1] = 3
        self.input = SynthesisInput(cfg["style_dim"], int(channels[0]), int(sizes[0]), sampling_rates[0], cutoffs[0])
        self.layer_names = []
        for idx in range(n + 1):
            prev = max(idx - 1, 0)
            layer = SynthesisLayer(
                cfg["style_dim"], idx == n, int(channels[prev]), int(channels[idx]), int(sizes[prev]), int(sizes[idx]),
                int(sampling_rates[prev]), int(sampling_rates[idx]), cutoffs[prev], cutoffs[idx], half_widths[prev],
                half_widths[idx], cfg["filter_size"], cfg["lrelu_upsampling"], cfg["conv_clamp"])
            name = f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, w):
        x = self.input(w)
        for name in self.layer_names:
            x = getattr(self, name)(x, w)
        return x * self.output_scale


class Generator(nn.Module):
    num_layers = 0  # no per-layer noise

    def __init__(self, cfg: dict):
        super().__init__()
        self.style_dim = cfg["style_dim"]
        self.mapping = MappingNetwork(cfg["style_dim"], cfg["style_dim"], cfg["n_mlp"], cfg["lr_mlp"])
        self.synthesis = SynthesisNetwork(cfg)

    @staticmethod
    def noise_res(j: int) -> int:
        raise IndexError("StyleGAN3 has no per-layer noise")

    def forward(self, z, noise):
        if noise:
            raise ValueError("StyleGAN3 has no per-layer noise")
        return self.synthesis(self.mapping(z))


def models(cfg: dict, device="cpu"):
    """(G, D) of a configuration file's sizes on `device`, with empty weights."""
    with torch.device(device):
        g = Generator(cfg)
        d = stylegan2.Discriminator(cfg["d_size"], cfg["d_channel_multiplier"], tuple(cfg["blur_kernel"]),
                                    cfg["stddev_group"])
    return g, d


def init_rule(name: str, cfg: dict) -> tuple:
    """(scale, shift) of a leaf's draw, randn * scale + shift: NVlabs' randn
    weights (mapping weights / lr_mlp) and style biases of 1, with every leaf
    that NVlabs starts at a constant made meaningful: frequencies inside the
    input's bandwidth (|f| <= 2 for all but ~2%), phases small, magnitude
    EMAs positive near 1, the input affine's weights small and its bias near
    1 (the rotation is normalized by its first two outputs), other biases
    small; D's leaves by StyleGAN2's rule."""
    if not name.startswith(("mapping.", "synthesis.")):
        return stylegan2.init_rule(name, cfg)
    if name.endswith("input.freqs"):
        return 0.7, 0.0
    if name.endswith("input.phases"):
        return 0.25, 0.0
    if name.endswith("magnitude_ema"):
        return 0.05, 1.0
    if name.endswith("input.affine.weight"):
        return 0.1, 0.0
    if name.endswith("affine.bias"):
        return 0.1, 1.0
    if name.startswith("mapping.fc") and name.endswith(".weight"):
        return 1.0 / cfg["lr_mlp"], 0.0
    if name.endswith("bias"):
        return 0.1, 0.0
    return 1.0, 0.0
