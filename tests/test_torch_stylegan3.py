"""StyleGAN3-T in the port (`rick_tpu_torch/nn/stylegan3.py`,
`ops/filtered_lrelu.py`) against `tests/torch_sg3_oracle.py`, NVlabs'
`networks_stylegan3.py` written out in plain PyTorch, on seeded random
weights at 32px (channel_base 512, channel_max 32: every kind of layer, up
by 2 and 4, channel counts 32 to 16), and the 256px configuration's layer
table and filters against NVlabs' published values and
`scipy.signal.firwin`.  The JAX package has no StyleGAN3."""

import importlib

import numpy as np
import pytest
import scipy.signal
import torch

from rick_tpu_torch import ops
from rick_tpu_torch.ckpt import generator3_state_dict_from_nvlabs
from rick_tpu_torch.metrics import Evaluator
from rick_tpu_torch.nn import Generator3, Generator3Config
from rick_tpu_torch.nn.stylegan3 import kaiser_lowpass
from rick_tpu_torch.utils import trace
from tests import torch_sg3_oracle as oracle
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

SMALL = Generator3Config(size=32, channel_base=512, channel_max=32)
FFHQU256 = Generator3Config()
FLRELU = importlib.import_module("rick_tpu_torch.ops.filtered_lrelu")  # the module: `ops` exports the function
TRUNK = dict(inception_stop_at="Mixed_6a", inception_resize_to=75)

# NVlabs' stylegan3-t at 256px, channel_base 16384 (`L{i}_{size}_{channels}`,
# as in stylegan3-t-ffhqu-256x256.pkl): per layer the input and output
# channels, input side, output side, sampling rates in and out, up and down
# factors, filter taps, and the up pass's padding (px0 = py0, px1 = py1)
TABLE_256 = [
    ("L0_36_512", 512, 512, 36, 36, 16, 16, 2, 2, 12, 12, 9, 8),
    ("L1_36_512", 512, 512, 36, 36, 16, 16, 2, 2, 12, 12, 9, 8),
    ("L2_36_512", 512, 512, 36, 36, 16, 16, 2, 2, 12, 12, 9, 8),
    ("L3_52_512", 512, 512, 36, 52, 16, 32, 4, 2, 24, 12, -6, -9),
    ("L4_52_512", 512, 512, 52, 52, 32, 32, 2, 2, 12, 12, 9, 8),
    ("L5_84_512", 512, 512, 52, 84, 32, 64, 4, 2, 24, 12, -6, -9),
    ("L6_84_512", 512, 512, 84, 84, 64, 64, 2, 2, 12, 12, 9, 8),
    ("L7_148_362", 512, 362, 84, 148, 64, 128, 4, 2, 24, 12, -6, -9),
    ("L8_148_256", 362, 256, 148, 148, 128, 128, 2, 2, 12, 12, 9, 8),
    ("L9_148_181", 256, 181, 148, 148, 128, 128, 2, 2, 12, 12, 9, 8),
    ("L10_276_128", 181, 128, 148, 276, 128, 256, 4, 2, 24, 12, -6, -9),
    ("L11_276_91", 128, 91, 276, 276, 256, 256, 2, 2, 12, 12, 9, 8),
    ("L12_276_64", 91, 64, 276, 276, 256, 256, 2, 2, 12, 12, 9, 8),
    ("L13_256_64", 64, 64, 276, 256, 256, 256, 2, 2, 12, 12, -11, -12),
    ("L14_256_3", 64, 3, 256, 256, 256, 256, 1, 1, 1, 1, 0, 0),
]


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def seeded_weights(g, seed: int) -> dict:
    """Every state-dict entry drawn from `seed`, each leaf meaningful:
    frequencies inside the input's bandwidth, small phases, magnitude EMAs
    near 1, the input affine's bias away from 0 (its rotation is normalized
    by it), the styles' affine bias near 1, mapping weights / lr_mlp."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in g.state_dict().items():
        x = torch.randn(v.shape, generator=gen)
        if k.endswith("freqs"):
            x = x * 0.7
        elif k.endswith("phases"):
            x = x * 0.25
        elif k.endswith("magnitude_ema"):
            x = x * 0.05 + 1.0
        elif k.endswith("input.affine.weight"):
            x = x * 0.1
        elif k.endswith("affine.bias"):
            x = x * 0.1 + 1.0
        elif k.startswith("mapping.fc") and k.endswith("weight"):
            x = x / SMALL.lr_mlp
        elif k.endswith("bias"):
            x = x * 0.1
        out[k] = x
    return out


@pytest.fixture(scope="module")
def models():
    g = Generator3(SMALL, rng=torch.Generator().manual_seed(0))
    sd = seeded_weights(g, 1)
    g.load_state_dict(sd)
    o = oracle.Generator(SMALL)
    o.load_state_dict(sd)
    return g.eval(), o.eval()


def test_layer_table_is_nvlabs():
    layers = FFHQU256.layers()
    got = [(x.name, x.in_channels, x.out_channels, x.in_size, x.out_size, x.in_sampling_rate, x.out_sampling_rate,
            x.up, x.down, x.up_taps, x.down_taps, x.padding[0], x.padding[1]) for x in layers]
    assert got == TABLE_256
    assert all(x.padding[:2] == x.padding[2:] for x in layers)
    cut, _, rates, _, sizes, channels = FFHQU256.schedule()
    assert (cut[0], rates[0], sizes[0], channels[0]) == (2.0, 16.0, 36.0, 512.0)  # the Fourier input
    # the oracle's own schedule (NVlabs' code as written) agrees
    table = oracle.SynthesisNetwork(512, 256, channel_base=16384).table
    for got_v, want in zip(FFHQU256.schedule(), (table[k] for k in ("cutoffs", "stopbands", "sampling_rates",
                                                                     "half_widths", "sizes", "channels"))):
        np.testing.assert_array_equal(got_v, want)


@pytest.mark.parametrize("layer", FFHQU256.layers()[:-1], ids=lambda x: x.name)
def test_filters_are_scipy_firwin(layer):
    """The port's Kaiser design against scipy in float64: the same formulas
    (np.kaiser is scipy's Kaiser window), so equal to 1e-12 of the largest
    tap."""
    for taps, cutoff, half_width in ((layer.up_taps, layer.in_cutoff, layer.in_half_width),
                                     (layer.down_taps, layer.out_cutoff, layer.out_half_width)):
        want = scipy.signal.firwin(taps, cutoff, width=half_width * 2, fs=layer.tmp_sampling_rate)
        got = kaiser_lowpass(taps, cutoff, half_width * 2, layer.tmp_sampling_rate)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        assert abs(got.sum() - 1.0) <= 1e-12


def test_state_dict_has_nvlabs_names(models):
    g, o = models
    assert list(g.state_dict()) == list(o.state_dict())
    assert "synthesis.L7_148_362.weight" in Generator3(FFHQU256, rng=torch.Generator().manual_seed(0),
                                                        device="meta").state_dict()
    keys = set(g.state_dict())
    assert {"mapping.fc0.weight", "mapping.fc1.bias", "mapping.w_avg", "synthesis.input.freqs",
            "synthesis.input.phases", "synthesis.input.weight", "synthesis.input.affine.weight",
            "synthesis.L0_36_32.magnitude_ema", "synthesis.L14_32_3.affine.bias"} <= keys
    assert not any(k.endswith(("up_filter", "down_filter", "transform")) for k in keys)


def _layer_outputs(g, z):
    """The input's and each layer's output, walking the synthesis network
    (the port's and the oracle's have the same modules)."""
    w = g.mapping(z)
    x = g.synthesis.input(w)
    out = [x]
    for name in g.synthesis.layer_names:
        x = getattr(g.synthesis, name)(x, w)
        out.append(x)
    return out


def test_image_and_every_layer_match_the_oracle(models):
    """The plain path (fast=False): the image and the input's and each
    layer's output, 1e-5 of max|oracle| (f32 sums in another order: a shared
    weight on x * s' against the oracle's per-sample grouped conv, the FIR
    passes y-first against x-first; measured up to 1.4e-6 at the 14th
    layer)."""
    g, o = models
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        img, aux = g([z])
        want_img = o(z)
        feats, want_feats = _layer_outputs(g, z), _layer_outputs(o, z)
    assert img.shape == (4, 3, 32, 32) and aux is None and len(feats) == len(want_feats) == 16
    assert torch.equal(feats[-1] * SMALL.output_scale, img)
    for got, want in zip(feats, want_feats):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-5
    assert _rel(img, want_img) <= 1e-5
    assert float(img.std()) > 0.05  # the weights carry a signal to the image


def test_fast_route_is_the_plain_path_on_the_cpu(models):
    """fast=True sends each 3x3 conv through `ops.modconv_act` on an input
    padded by 1 (on the CPU its plain version), with the bias in its
    epilogue, slope 1 and gain 1, and the 14 filtered leaky ReLUs through
    `ops.filtered_lrelu_act` (K7; on the CPU the plain chain), ToRGB's
    through `ops.filtered_lrelu`: 1e-6 of max|plain| (the same convolution,
    in another order of additions at most)."""
    g, _ = models
    z = torch.randn((2, 512), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        with trace.recording():
            fast, _ = g([z], fast=True)
            calls = {k: c for k, (c, _) in trace.counters().items()}
        plain, _ = g([z])
    assert calls == {"ops.modconv_act": 14, "ops.filtered_lrelu_act": 14, "ops.filtered_lrelu": 1,
                     "ops.fused_bias_act": 2}
    assert _rel(fast, plain) <= 1e-6


def test_bad_calls_raise(models):
    g, _ = models
    z = torch.zeros((1, 512))
    with pytest.raises(ValueError, match="float32"):
        g([z], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mixing"):
        g([z, z])
    with pytest.raises(ValueError, match="noise"):
        g([z], noise=[torch.zeros(1)])
    assert g.layer_noise(3, torch.Generator(), None) == [] and g.num_layers == 0


def _flrelu_case(seed, up, down, channels=5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, channels, 16, 16), generator=gen)
    b = torch.randn((channels,), generator=gen)
    fu = torch.as_tensor(scipy.signal.firwin(6 * up, 2.5, width=3.0, fs=8 * up), dtype=torch.float32)
    fd = torch.as_tensor(scipy.signal.firwin(6 * down, 2.0, width=3.0, fs=8 * up), dtype=torch.float32)
    return x * 40, fu, fd, b


@pytest.mark.parametrize("up,down,padding", [(2, 2, (9, 8, 9, 8)), (4, 2, (-6, -9, -6, -9)), (2, 2, (-3, -4, 2, 1))])
def test_filtered_lrelu_matches_nvlabs_reference(up, down, padding):
    """`filtered_lrelu_ref` against the oracle's `_filtered_lrelu_ref`
    (zero insertion on both axes, then the passes x-first), with the clamp
    reached: 1e-6 of max|oracle| (f32 sums in another order)."""
    x, fu, fd, b = _flrelu_case(4, up, down)
    kw = dict(up=up, down=down, padding=padding, gain=2**0.5, slope=0.2, clamp=25.0)
    want = oracle.filtered_lrelu(x, fu, fd, b, **kw)
    got = ops.filtered_lrelu_ref(x, fu, fd, b, **kw)
    assert got.shape == want.shape and _rel(got, want) <= 1e-6
    assert float(want.abs().max()) > 0 and bool((oracle.bias_act(x, b).abs() * 2**0.5 > 25).any())
    # no filters, no resampling: the ToRGB case, bias and clamp alone
    kw = dict(gain=1.0, slope=1.0, clamp=25.0)
    assert torch.equal(ops.filtered_lrelu_ref(x, None, None, b, **kw), (x + b[:, None, None]).clamp(-25, 25))


def test_filtered_lrelu_in_blocks_of_channels(monkeypatch):
    """Blocks of channels (a small `GRID_ELEMS`) give what one block gives;
    with and without the bias."""
    x, fu, fd, b = _flrelu_case(5, 4, 2, channels=7)
    kw = dict(up=4, down=2, padding=(-6, -9, -6, -9), clamp=25.0)
    whole = ops.filtered_lrelu(x, fu, fd, b, **kw)
    whole_nb = ops.filtered_lrelu(x, fu, fd, None, **kw)
    monkeypatch.setattr(FLRELU, "GRID_ELEMS", 2 * 3 * 49 * 49)  # blocks of 3, 3 and 1 channels
    assert torch.allclose(ops.filtered_lrelu(x, fu, fd, b, **kw), whole, rtol=0, atol=1e-6 * float(whole.abs().max()))
    assert torch.allclose(ops.filtered_lrelu(x, fu, fd, None, **kw), whole_nb, rtol=0,
                          atol=1e-6 * float(whole_nb.abs().max()))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("layer", FFHQU256.layers()[:-1], ids=lambda x: x.name)
def test_filtered_lrelu_act_is_the_chain_at_each_filtered_layer(layer, bias):
    """K7's wrapper on a CPU tensor at each of the 256px configuration's 14
    filtered layers (its up, down, taps, padding, filters and input side; 1
    image of 2 channels): the plain chain, bitwise, and NVlabs' reference
    within 1e-6 of max|oracle| (f32 sums in another order); with the clamp
    reached, and the output side the layer's."""
    gen = torch.Generator().manual_seed(int(layer.name[1:].split("_")[0]))
    side = layer.in_size + layer.kernel - 1  # the full-padding conv's output
    x = torch.randn((1, 2, side, side), generator=gen) * 100
    b = torch.randn((2,), generator=gen) if bias else None
    # the layer's filters, as the model builds them
    fu = kaiser_lowpass(layer.up_taps, layer.in_cutoff, layer.in_half_width * 2, layer.tmp_sampling_rate)
    fd = kaiser_lowpass(layer.down_taps, layer.out_cutoff, layer.out_half_width * 2, layer.tmp_sampling_rate)
    fu, fd = (torch.as_tensor(f, dtype=torch.float32) for f in (fu, fd))
    kw = dict(up=layer.up, down=layer.down, padding=layer.padding, gain=2**0.5, slope=0.2, clamp=256.0)
    ops.reset_launch_counts()
    got = ops.filtered_lrelu_act(x, fu, fd, b, **kw)
    assert got.shape == (1, 2, layer.out_size, layer.out_size)
    assert torch.equal(got, ops.filtered_lrelu_ref(x, fu, fd, b, **kw))
    assert _rel(got, oracle.filtered_lrelu(x, fu, fd, b, **kw)) <= 1e-6
    assert bool((got.abs() > 100).any()) and ops.filtered_lrelu_act.launches == 0


def test_filtered_lrelu_act_refusals():
    """K7's wrapper raises where the kernel would not take the call, on the
    CPU as on the card: under autograd, on another dtype, on up/down/taps
    outside up 2 or 4 with 6 up taps and down 2 with 12 taps, on a bias or
    padding of the wrong size."""
    x, fu, fd, b = _flrelu_case(7, 2, 2, channels=3)
    kw = dict(up=2, down=2, padding=(9, 8, 9, 8), clamp=256.0)
    ops.filtered_lrelu_act(x, fu, fd, b, **kw)
    with pytest.raises(NotImplementedError):
        ops.filtered_lrelu_act(x.clone().requires_grad_(True), fu, fd, b, **kw)
    with pytest.raises(NotImplementedError):
        ops.filtered_lrelu_act(x, fu, fd, b.clone().requires_grad_(True), **kw)
    with torch.no_grad():
        ops.filtered_lrelu_act(x.clone().requires_grad_(True), fu, fd, b, **kw)
    with pytest.raises(ValueError, match="dtype"):
        ops.filtered_lrelu_act(x.double(), fu, fd, b, **kw)
    with pytest.raises(ValueError, match="dtype"):
        ops.filtered_lrelu_act(x, fu.double(), fd, b, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.filtered_lrelu_act(x.transpose(2, 3), fu, fd, b, **kw)
    for up, down in ((1, 2), (3, 2), (8, 2), (2, 1), (2, 4), (4, 4)):
        with pytest.raises(ValueError, match="the kernel takes up"):
            ops.filtered_lrelu_act(x, fu, fd, b, **dict(kw, up=up, down=down))
    with pytest.raises(ValueError, match="fu"):
        ops.filtered_lrelu_act(x, fu, fd, b, **dict(kw, up=4, padding=(-6, -9, -6, -9)))
    with pytest.raises(ValueError, match="fd"):
        ops.filtered_lrelu_act(x, fu, fd[:6].contiguous(), b, **kw)
    with pytest.raises(ValueError, match="b "):
        ops.filtered_lrelu_act(x, fu, fd, b[:2].contiguous(), **kw)
    with pytest.raises(ValueError, match="padding"):
        ops.filtered_lrelu_act(x, fu, fd, b, **dict(kw, padding=(9, 8)))
    with pytest.raises(ValueError, match="no output"):
        ops.filtered_lrelu_act(x, fu, fd, b, **dict(kw, padding=(-40, -40, 0, 0)))


def test_filtered_lrelu_act_work_counts_the_polyphase_passes():
    """K7's bytes and operations (`tools/roofline.py`), which its bound in
    `chip_smoke.py` reads, at layer 10 of the 256px chunk (batch 100): the
    counts written out, and the bound they give, 2.219 ms by operations."""
    from rick_tpu_torch.tools.roofline import bound, filtered_lrelu_work

    n, c, h, m, o = 100, 128, 150, 562, 276  # input, intermediate and output sides
    nbytes, ops_ = filtered_lrelu_work(n, c, h, h, o, o, 4, 2, 24, 12, (-6, -9, -6, -9))
    assert nbytes == 4 * n * c * (h * h + o * o)
    assert ops_ == n * c * (2 * ((h * m + m * m) * 6 + (m * o + o * o) * 12) + 4 * m * m)
    ms, by = bound(nbytes, ops_)
    assert by == "operations" and round(ms, 3) == 2.219
    assert FLRELU.output_size(h, 4, 2, 24, 12, -6, -9) == o


def test_filtered_lrelu_double_backward():
    """The plain chain is differentiable twice (for training, later): the
    second derivatives by autograd against finite differences, in float64."""
    x, fu, fd, b = _flrelu_case(6, 2, 2, channels=2)
    x, b = x[:1, :, :6, :6].double().requires_grad_(True), b.double().requires_grad_(True)

    def fn(x, b):
        return ops.filtered_lrelu_ref(x, fu.double(), fd.double(), b, up=2, down=2, padding=(9, 8, 9, 8), clamp=256.0)

    assert torch.autograd.gradgradcheck(fn, (x / 40, b))


def test_nvlabs_state_dict_converts(models):
    """NVlabs' G_ema holds the filters and the input's transform: the
    converter checks them against the port's and drops them."""
    g, o = models
    nv = oracle.nvlabs_state_dict(o)
    assert any(k.endswith("up_filter") for k in nv)
    sd = generator3_state_dict_from_nvlabs(g, nv)
    assert set(sd) == set(g.state_dict())
    g2 = Generator3(SMALL, rng=torch.Generator().manual_seed(9))
    g2.load_state_dict(sd)
    z = torch.randn((2, 512), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(g2([z])[0], g([z])[0])
    bad = dict(nv)
    bad["synthesis.L3_36_32.down_filter"] = bad["synthesis.L3_36_32.down_filter"] * 1.01
    with pytest.raises(ValueError, match="differs"):
        generator3_state_dict_from_nvlabs(g, bad)
    bad = dict(nv)
    bad["synthesis.L14_32_3.up_filter"] = torch.ones(12)  # ToRGB has no filter
    with pytest.raises(ValueError, match="no such buffer"):
        generator3_state_dict_from_nvlabs(g, bad)


def test_evaluator_runs_stylegan3(models):
    """The Evaluator unchanged on a Generator3: its activations of fixed
    latents against the oracle's images through the same cut Inception,
    1e-4 of max|ref| (G's 1e-6 carried through Inception's f32 convs); a
    whole FID call, whose draws hold no noise."""
    g, o = models
    real = np.random.default_rng(0).integers(0, 256, (8, 3, 32, 32), dtype=np.uint8)
    ev = Evaluator(SMALL, fid_real_samples=real, inception_nsamples=8, batch_size=8, gen_batch=4, seed=1,
                   device="cpu", **TRUNK)
    z = torch.randn((8, 512), generator=torch.Generator().manual_seed(5))
    acts = ev.activations(g, z)
    with torch.inference_mode():
        want = torch.cat([ev.inception.pool3(o(zc), stop_at="Mixed_6a", resize_to=75).float() for zc in z.split(4)])
    assert acts.shape == (8, 768) and _rel(acts, want) <= 1e-4
    score = ev.compute_inception_score(g)
    assert np.isfinite(score["fid"]) and ev.last_stats[0].shape == (768,)
