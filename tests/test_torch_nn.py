"""Each `rick_tpu_torch.nn` block against its `rick_tpu.nn.blocks` function,
with the JAX params converted into the module and identical numpy inputs.
Zero-initialized biases and noise weights are made random first, so that
their paths count.  f32 on both sides: rtol 1e-4, atol 1e-4 * max|ref|."""

import jax
import numpy as np
import pytest
import torch

from rick_tpu.nn import blocks as jb
from rick_tpu.nn import DiscriminatorConfig as JDiscriminatorConfig
from rick_tpu.nn import GeneratorConfig as JGeneratorConfig
from rick_tpu.nn import discriminator_init, generator_init
from rick_tpu_torch import nn as tnn
from rick_tpu_torch.ckpt import discriminator_state_dict_from_jax, generator_state_dict_from_jax
from rick_tpu_torch.ckpt.convert import _styled_to_sd, _torgb_to_sd
from tests.torch_port_helpers import close, j, n, one_torch_thread, perturb_zeros, rand, t  # noqa: F401

RTOL, ATOL_FRAC = 1e-4, 1e-4
RNG = dict(rng=torch.Generator().manual_seed(0))


def _load(module, sd):
    module.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def _strip(sd, prefix):
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def _key(i):
    return jax.random.key(i)


def test_pixel_norm_matches_jax():
    z = rand((3, 16), 0)
    close(tnn.pixel_norm(t(z)), jb.pixel_norm(j(z)), rtol=RTOL, atol_frac=ATOL_FRAC)
    close(tnn.PixelNorm()(t(z)), jb.pixel_norm(j(z)), rtol=RTOL, atol_frac=ATOL_FRAC)


@pytest.mark.parametrize("lr_mul,activation,bias_init", [(0.01, "fused_lrelu", 0.0), (1.0, None, 1.0)])
def test_equal_linear_matches_jax(lr_mul, activation, bias_init):
    p = perturb_zeros(jb.equal_linear_init(_key(0), 16, 8, lr_mul=lr_mul, bias_init=bias_init), 1)
    m = _load(tnn.EqualLinear(16, 8, lr_mul=lr_mul, activation=activation, **RNG),
              {"weight": p["weight"], "bias": p["bias"]})
    x = rand((3, 16), 2)
    want = jb.equal_linear_apply(p, j(x), lr_mul=lr_mul, activation=activation)
    close(m(t(x)), want, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_equal_conv2d_matches_jax():
    p = perturb_zeros(jb.equal_conv2d_init(_key(1), 4, 6, 3), 2)
    m = _load(tnn.EqualConv2d(4, 6, 3, padding=1, **RNG), p)
    x = rand((2, 4, 7, 7), 3)
    close(m(t(x)), jb.equal_conv2d_apply(p, j(x), padding=1), rtol=RTOL, atol_frac=ATOL_FRAC)


MODCONV_CASES = {
    "plain": dict(k=3),
    "upsample": dict(k=3, upsample=True),
    "downsample": dict(k=3, downsample=True),
    "no_demod_1x1": dict(k=1, demodulate=False),
}


@pytest.mark.parametrize("case", list(MODCONV_CASES), ids=list(MODCONV_CASES))
def test_modulated_conv2d_matches_jax(case):
    kw = dict(MODCONV_CASES[case])
    k = kw.pop("k")
    p = jb.modulated_conv2d_init(_key(2), 6, 5, k, 12)
    m = _load(tnn.ModulatedConv2d(6, 5, k, 12, **kw, **RNG), {
        "weight": np.asarray(p["weight"])[None],
        "modulation.weight": p["modulation"]["weight"],
        "modulation.bias": p["modulation"]["bias"],
    })
    x, s = rand((2, 6, 8, 8), 3), rand((2, 12), 4)
    want = jb.modulated_conv2d_apply(p, j(x), j(s), **kw)
    close(m(t(x), t(s)), want, rtol=RTOL, atol_frac=ATOL_FRAC)


@pytest.mark.parametrize("upsample", [False, True], ids=["same", "upsample"])
@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "no_noise"])
def test_styled_conv_matches_jax(upsample, with_noise):
    p = perturb_zeros(jb.styled_conv_init(_key(3), 8, 6, 3, 12), 5)
    sd = {}
    _styled_to_sd(p, "s", sd)
    m = _load(tnn.StyledConv(8, 6, 3, 12, upsample=upsample, **RNG), _strip(sd, "s"))
    x, s = rand((2, 8, 8, 8), 6), rand((2, 12), 7)
    res = 16 if upsample else 8
    noise = rand((2, 1, res, res), 8) if with_noise else None
    want = jb.styled_conv_apply(p, j(x), j(s), None if noise is None else j(noise), upsample=upsample)
    got = m(t(x), t(s), None if noise is None else t(noise))
    close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)


@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "no_skip"])
def test_to_rgb_matches_jax(with_skip):
    p = perturb_zeros(jb.to_rgb_init(_key(4), 8, 12), 9)
    sd = {}
    _torgb_to_sd(p, "r", sd)
    m = _load(tnn.ToRGB(8, 12, **RNG), _strip(sd, "r"))
    x, s = rand((2, 8, 8, 8), 10), rand((2, 12), 11)
    skip = rand((2, 3, 4, 4), 12) if with_skip else None
    want = jb.to_rgb_apply(p, j(x), j(s), None if skip is None else j(skip))
    close(m(t(x), t(s), None if skip is None else t(skip)), want, rtol=RTOL, atol_frac=ATOL_FRAC)


CONV_LAYER_CASES = {
    "plain": dict(k=3, kw={}, keys={"weight": "0.weight", "act_bias": "1.bias"}),
    "downsample": dict(k=3, kw=dict(downsample=True), keys={"weight": "1.weight", "act_bias": "2.bias"}),
    "skip_no_act_no_bias": dict(k=1, kw=dict(downsample=True, activate=False, bias=False), keys={"weight": "1.weight"}),
}


@pytest.mark.parametrize("case", list(CONV_LAYER_CASES), ids=list(CONV_LAYER_CASES))
def test_conv_layer_matches_jax(case):
    c = CONV_LAYER_CASES[case]
    init_kw = {k: v for k, v in c["kw"].items() if k in ("bias", "activate")}
    p = perturb_zeros(jb.conv_layer_init(_key(5), 4, 6, c["k"], **init_kw), 13)
    m = _load(tnn.ConvLayer(4, 6, c["k"], **c["kw"], **RNG), {c["keys"][k]: v for k, v in p.items()})
    x = rand((2, 4, 8, 8), 14)
    apply_kw = {k: v for k, v in c["kw"].items() if k in ("downsample", "activate")}
    close(m(t(x)), jb.conv_layer_apply(p, j(x), **apply_kw), rtol=RTOL, atol_frac=ATOL_FRAC)


def test_res_block_matches_jax():
    p = perturb_zeros(jb.res_block_init(_key(6), 4, 8), 15)
    sd = {
        "conv1.0.weight": p["conv1"]["weight"], "conv1.1.bias": p["conv1"]["act_bias"],
        "conv2.1.weight": p["conv2"]["weight"], "conv2.2.bias": p["conv2"]["act_bias"],
        "skip.1.weight": p["skip"]["weight"],
    }
    m = _load(tnn.ResBlock(4, 8, **RNG), sd)
    x = rand((2, 4, 8, 8), 16)
    for got, want in zip(m(t(x)), jb.res_block_apply(p, j(x))):
        close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)


@pytest.mark.parametrize("batch,splits", [(4, 1), (6, 1), (8, 2), (50, 1)])
def test_minibatch_stddev_matches_jax(batch, splits):
    x = rand((batch, 4, 3, 3), 17)
    got = tnn.minibatch_stddev(t(x), splits=splits)
    close(got, jb.minibatch_stddev(j(x), splits=splits), rtol=RTOL, atol_frac=ATOL_FRAC)


def test_noise_injection_and_constant_input():
    m = tnn.NoiseInjection()
    x = t(rand((2, 3, 4, 4), 18))
    assert torch.equal(m(x), x) and torch.equal(m(x, None), x)
    with torch.no_grad():
        m.weight.fill_(0.5)
    nz = t(rand((1, 1, 4, 4), 19))
    assert torch.allclose(m(x, nz), x + 0.5 * nz)
    ci = tnn.ConstantInput(5, **RNG)
    assert ci(3).shape == (3, 5, 4, 4) and torch.equal(ci(3)[2], ci.input[0])


def test_generator_state_dict_is_the_converter_layout():
    cfg = JGeneratorConfig(size=16, style_dim=32, n_mlp=2)
    sd = generator_state_dict_from_jax(cfg, generator_init(_key(7), cfg))
    g = tnn.Generator(16, 32, 2, **RNG)
    own = g.state_dict()
    assert set(own) == set(sd)
    assert all(tuple(own[k].shape) == sd[k].shape for k in sd)


def test_discriminator_state_dict_is_the_converter_layout():
    cfg = JDiscriminatorConfig(size=16)
    sd = discriminator_state_dict_from_jax(cfg, discriminator_init(_key(8), cfg))
    own = tnn.Discriminator(16, **RNG).state_dict()
    assert set(own) == set(sd)
    assert all(tuple(own[k].shape) == sd[k].shape for k in sd)


def test_modules_draw_weights_from_the_given_generator_only():
    a = tnn.Generator(8, 16, 2, rng=torch.Generator().manual_seed(3))
    b = tnn.Generator(8, 16, 2, rng=torch.Generator().manual_seed(3))
    c = tnn.Generator(8, 16, 2, rng=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["input.input"], sc["input.input"])
    assert n(sa["convs.0.noise.weight"]).shape == (1,)


# ---------------------------------------------------------------------------
# fast=True: the stride-1 StyledConvs through K6 (`modconv_act`)
# ---------------------------------------------------------------------------


def _counted(fn):
    """fn()'s result and the calls of each kernel wrapper it made."""
    from rick_tpu_torch.utils import trace

    with trace.recording():
        out = fn()
        calls = {k: c for k, (c, _) in trace.counters().items()}
    return out, calls


def _perturbed(module, seed: int):
    """`module` with its all-zero params (biases, noise weights) made random."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return module.eval()


@pytest.mark.parametrize("noise_batch", [2, 1], ids=["noise_B", "noise_1"])
def test_styled_conv_fast_takes_modconv_act_and_matches_the_training_chain(noise_batch):
    """Without upsample, given noise and an f32 input, fast=True takes K6's
    wrapper (on the CPU its plain version) and fast=False K3's chain: the
    same operations in the same order."""
    m = _perturbed(tnn.StyledConv(8, 6, 3, 12, **RNG), 1)
    x, s, noise = t(rand((2, 8, 8, 8), 2)), t(rand((2, 12), 3)), t(rand((noise_batch, 1, 8, 8), 4))
    with torch.no_grad():
        slow, slow_calls = _counted(lambda: m(x, s, noise))
        fast, fast_calls = _counted(lambda: m(x, s, noise, fast=True))
    assert fast_calls.get("ops.modconv_act") == 1 and "ops.modconv_epilogue" not in fast_calls
    assert slow_calls.get("ops.modconv_epilogue") == 1 and "ops.modconv_act" not in slow_calls
    assert torch.equal(fast, slow)


@pytest.mark.parametrize("noise", ["buffers", "drawn"])
def test_generator_fast_takes_modconv_act_at_every_stride1_styled_conv(noise):
    """G with fast=True against fast=False: conv1 and the second conv of
    every block through K6, the upsample convs through K4, no K3; images and
    features within 1e-5 (K4's plain chain blurs in another order)."""
    g = _perturbed(tnn.Generator(8, 16, 2, **RNG), 5)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(6))

    def run(fast):
        rng = torch.Generator().manual_seed(7) if noise == "drawn" else None
        return g([z], rng=rng, return_feats=True, fast=fast)

    with torch.no_grad():
        (slow, slow_feats), slow_calls = _counted(lambda: run(False))
        (fast, fast_feats), fast_calls = _counted(lambda: run(True))
    blocks = len(g.to_rgbs)
    assert fast_calls["ops.modconv_act"] == 1 + blocks and fast_calls["ops.convt_blur_act"] == blocks
    assert "ops.modconv_epilogue" not in fast_calls
    assert slow_calls["ops.modconv_epilogue"] == 1 + blocks and "ops.modconv_act" not in slow_calls
    for got, want in zip([fast] + fast_feats, [slow] + slow_feats):
        close(got, want, rtol=1e-5, atol_frac=1e-5)


def test_bf16_conv1_keeps_modconv_epilogue_under_fast():
    """With the trunk in bf16, G's conv1 computes in bf16 and keeps K3's bf16
    route under fast=True; the later, f32 stride-1 convs take K6."""
    g = _perturbed(tnn.Generator(8, 16, 2, **RNG), 8)
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        (img, _), calls = _counted(lambda: g([z], dtype=torch.bfloat16, fast=True))
        want, _ = g([z], dtype=torch.bfloat16)
    assert calls["ops.modconv_epilogue"] == 1 and calls["ops.modconv_act"] == len(g.to_rgbs)
    close(img, want, rtol=1e-5, atol_frac=1e-5)
