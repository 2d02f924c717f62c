"""StyleGAN3-T's generator in plain PyTorch, the tier-1 tests' oracle for the
port's `rick_tpu_torch/nn/stylegan3.py`.

It follows NVlabs' `training/networks_stylegan3.py` (`MappingNetwork`,
`SynthesisInput`, `SynthesisLayer`, `SynthesisNetwork`, `modulated_conv2d`)
and the reference paths of its ops, `_filtered_lrelu_ref`,
`_upfirdn2d_ref` and `_bias_act_ref`, line by line: the per-sample weights of
a grouped convolution, `affine_grid` for the Fourier features, zero
insertion on both axes before the separable FIR, and the filters of
`scipy.signal.firwin`.  Float32, TF32 off where it matters (the CPU).  It
imports nothing of the port.

Departures from NVlabs: everything runs in float32 (NVlabs runs the four
highest-resolution layers in fp16 on a GPU; the clamp at 256 is kept); the
filters and the input's `transform` are buffers kept out of the state dict,
so that the port's state dict loads as it is (`nvlabs_state_dict` adds them
back, as NVlabs' G_ema holds them); no truncation, no `update_emas`, no
class conditioning.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)


def bias_act(x, b=None, act="linear", alpha=0.2, gain=None, clamp=None):
    if b is not None:
        x = x + b.reshape([-1 if i == 1 else 1 for i in range(x.ndim)])
    if act == "lrelu":
        x = F.leaky_relu(x, alpha)
        gain = SQRT2 if gain is None else gain
    gain = 1.0 if gain is None else gain
    if gain != 1:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def upfirdn2d(x, f, up=1, down=1, padding=(0, 0, 0, 0), gain=1):
    """NVlabs' `_upfirdn2d_ref`: padding is (px0, px1, py0, py1); a 1-D f is
    separable (x pass, then y pass)."""
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    batch, ch, h, w = x.shape
    px0, px1, py0, py1 = padding
    x = x.reshape([batch, ch, h, 1, w, 1])
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape([batch, ch, h * up, w * up])
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = f * (gain ** (f.ndim / 2))
    f = f.to(x.dtype).flip(list(range(f.ndim)))
    f = f[None, None].repeat([ch, 1] + [1] * f.ndim)
    if f.ndim == 4:
        x = F.conv2d(x, f, groups=ch)
    else:
        x = F.conv2d(x, f.unsqueeze(2), groups=ch)
        x = F.conv2d(x, f.unsqueeze(3), groups=ch)
    return x[:, :, ::down, ::down]


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=(0, 0, 0, 0), gain=SQRT2, slope=0.2,
                   clamp=None):
    """NVlabs' `_filtered_lrelu_ref`."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up**2)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down)


def modulated_conv2d(x, w, s, demodulate=True, padding=0, input_gain=None):
    batch = x.shape[0]
    out_ch, in_ch, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    if demodulate:
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * dcoefs.unsqueeze(2).unsqueeze(3).unsqueeze(4)
    if input_gain is not None:
        w = w * input_gain.expand(batch, in_ch).unsqueeze(1).unsqueeze(3).unsqueeze(4)
    x = x.reshape(1, -1, *x.shape[2:])
    x = F.conv2d(x, w.reshape(-1, in_ch, kh, kw).to(x.dtype), padding=padding, groups=batch)
    return x.reshape(batch, -1, *x.shape[2:])


class FullyConnectedLayer(nn.Module):
    def __init__(self, in_features, out_features, activation="linear", lr_multiplier=1.0):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.zeros([out_features, in_features]))
        self.bias = nn.Parameter(torch.zeros([out_features]))
        self.weight_gain = lr_multiplier / np.sqrt(in_features)
        self.bias_gain = lr_multiplier

    def forward(self, x):
        w = self.weight * self.weight_gain
        b = self.bias * self.bias_gain
        if self.activation == "linear":
            return torch.addmm(b.unsqueeze(0), x, w.t())
        return bias_act(x.matmul(w.t()), b, act=self.activation)


class MappingNetwork(nn.Module):
    def __init__(self, z_dim, w_dim, num_layers=2, lr_multiplier=0.01):
        super().__init__()
        self.num_layers = num_layers
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(z_dim if idx == 0 else w_dim, w_dim, activation="lrelu",
                                                          lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.zeros([w_dim]))

    def forward(self, z):
        x = z * (z.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        return x


class SynthesisInput(nn.Module):
    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.channels, self.size = channels, np.broadcast_to(np.asarray(size), [2])
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        self.weight = nn.Parameter(torch.zeros([channels, channels]))
        self.affine = FullyConnectedLayer(w_dim, 4)
        self.register_buffer("transform", torch.eye(3, 3), persistent=False)
        self.register_buffer("freqs", torch.zeros([channels, 2]))
        self.register_buffer("phases", torch.zeros([channels]))

    def forward(self, w):
        transforms = self.transform.unsqueeze(0)
        freqs = self.freqs.unsqueeze(0)
        phases = self.phases.unsqueeze(0)
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
        theta[0, 0] = 0.5 * self.size[0] / self.sampling_rate
        theta[1, 1] = 0.5 * self.size[1] / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, int(self.size[1]), int(self.size[0])], align_corners=False)
        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = x + phases.unsqueeze(1).unsqueeze(2)
        x = torch.sin(x * (np.pi * 2))
        x = x * amplitudes.unsqueeze(1).unsqueeze(2)
        x = x @ (self.weight / np.sqrt(self.channels)).t()
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    def __init__(self, w_dim, is_torgb, is_critically_sampled, in_channels, out_channels, in_size, out_size,
                 in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff, in_half_width, out_half_width,
                 conv_kernel=3, filter_size=6, lrelu_upsampling=2, conv_clamp=256):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_size = np.broadcast_to(np.asarray(in_size), [2])
        self.out_size = np.broadcast_to(np.asarray(out_size), [2])
        self.tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else lrelu_upsampling)
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels)
        self.weight = nn.Parameter(torch.zeros([out_channels, in_channels, self.conv_kernel, self.conv_kernel]))
        self.bias = nn.Parameter(torch.zeros([out_channels]))
        self.register_buffer("magnitude_ema", torch.ones([]))
        self.up_factor = int(np.rint(self.tmp_sampling_rate / in_sampling_rate))
        assert in_sampling_rate * self.up_factor == self.tmp_sampling_rate
        self.up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        self.register_buffer("up_filter", self.design_lowpass_filter(
            numtaps=self.up_taps, cutoff=in_cutoff, width=in_half_width * 2, fs=self.tmp_sampling_rate),
            persistent=False)
        self.down_factor = int(np.rint(self.tmp_sampling_rate / out_sampling_rate))
        assert out_sampling_rate * self.down_factor == self.tmp_sampling_rate
        self.down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        self.register_buffer("down_filter", self.design_lowpass_filter(
            numtaps=self.down_taps, cutoff=out_cutoff, width=out_half_width * 2, fs=self.tmp_sampling_rate),
            persistent=False)
        pad_total = (self.out_size - 1) * self.down_factor + 1
        pad_total -= (self.in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])]

    def forward(self, x, w):
        input_gain = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / np.sqrt(self.in_channels * (self.conv_kernel**2)))
        x = modulated_conv2d(x=x, w=self.weight, s=styles, padding=self.conv_kernel - 1,
                             demodulate=(not self.is_torgb), input_gain=input_gain)
        gain = 1 if self.is_torgb else np.sqrt(2)
        slope = 1 if self.is_torgb else 0.2
        x = filtered_lrelu(x=x, fu=self.up_filter, fd=self.down_filter, b=self.bias, up=self.up_factor,
                           down=self.down_factor, padding=self.padding, gain=gain, slope=slope, clamp=self.conv_clamp)
        assert x.shape[1:] == (self.out_channels, int(self.out_size[1]), int(self.out_size[0]))
        return x

    @staticmethod
    def design_lowpass_filter(numtaps, cutoff, width, fs):
        if numtaps == 1:
            return None
        return torch.as_tensor(scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs),
                               dtype=torch.float32)


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim, img_resolution, img_channels=3, channel_base=32768, channel_max=512, num_layers=14,
                 num_critical=2, first_cutoff=2, first_stopband=2**2.1, last_stopband_rel=2**0.3, margin_size=10,
                 output_scale=0.25, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.output_scale = output_scale
        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels
        self.table = dict(cutoffs=cutoffs, stopbands=stopbands, sampling_rates=sampling_rates,
                          half_widths=half_widths, sizes=sizes, channels=channels)
        self.input = SynthesisInput(w_dim=w_dim, channels=int(channels[0]), size=int(sizes[0]),
                                    sampling_rate=sampling_rates[0], bandwidth=cutoffs[0])
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SynthesisLayer(
                w_dim=w_dim, is_torgb=(idx == num_layers), is_critically_sampled=(idx >= num_layers - num_critical),
                in_channels=int(channels[prev]), out_channels=int(channels[idx]), in_size=int(sizes[prev]),
                out_size=int(sizes[idx]), in_sampling_rate=int(sampling_rates[prev]),
                out_sampling_rate=int(sampling_rates[idx]), in_cutoff=cutoffs[prev], out_cutoff=cutoffs[idx],
                in_half_width=half_widths[prev], out_half_width=half_widths[idx], **layer_kwargs)
            name = f"L{idx}_{layer.out_size[0]}_{layer.out_channels}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, w):
        x = self.input(w)
        for name in self.layer_names:
            x = getattr(self, name)(x, w)
        return x * self.output_scale


class Generator(nn.Module):
    """G(z) of a port `Generator3Config`'s sizes, with empty weights."""

    def __init__(self, cfg):
        super().__init__()
        self.mapping = MappingNetwork(cfg.style_dim, cfg.style_dim, cfg.n_mlp, cfg.lr_mlp)
        self.synthesis = SynthesisNetwork(
            cfg.style_dim, cfg.size, channel_base=cfg.channel_base, channel_max=cfg.channel_max,
            num_layers=cfg.synthesis_layers, num_critical=cfg.num_critical, first_cutoff=cfg.first_cutoff,
            first_stopband=cfg.first_stopband, last_stopband_rel=cfg.last_stopband_rel, margin_size=cfg.margin_size,
            output_scale=cfg.output_scale, filter_size=cfg.filter_size, lrelu_upsampling=cfg.lrelu_upsampling,
            conv_clamp=cfg.conv_clamp)

    def forward(self, z):
        return self.synthesis(self.mapping(z))


def nvlabs_state_dict(g: Generator) -> dict:
    """The state dict NVlabs' G_ema would hold: the oracle's, with each
    layer's filters and the input's `transform` as NVlabs keeps them."""
    sd = dict(g.state_dict())
    sd["synthesis.input.transform"] = g.synthesis.input.transform.clone()
    for name in g.synthesis.layer_names:
        layer = getattr(g.synthesis, name)
        for buf in ("up_filter", "down_filter"):
            if getattr(layer, buf) is not None:
                sd[f"synthesis.{name}.{buf}"] = getattr(layer, buf).clone()
    return sd
