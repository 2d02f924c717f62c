"""The port's Fisher round against `rick_tpu.train.fisher` on the CPU.

Same 16px EMA weights (converted from `rick_tpu`'s init, biases and noise
weights made random), the same latents and "real" images from numpy, and
the constant noise buffers on both sides (`const_noise=True`).  Compared:
every FIM entry, and the freeze / prune masks, from the same FIMs and end to
end, leaving out filters whose score lies within 2% of a cutline, where
rounding may put a filter on either side (as tests/test_reference_parity.py
does).
"""

import jax
import numpy as np
import pytest
import torch

from rick_tpu.nn import DiscriminatorConfig, GeneratorConfig, discriminator_init, generator_init
from rick_tpu.train import fisher as jf
from rick_tpu_torch.ckpt import (
    d_masks_from_jax,
    discriminator_state_dict_from_jax,
    g_masks_from_jax,
    generator_state_dict_from_jax,
)
from rick_tpu_torch.nn.blocks import FusedLeakyReLU, pixel_norm
from rick_tpu_torch.train import accumulate_fims, fisher_round, masks_from_fims
from tests.torch_port_helpers import (  # noqa: F401
    close,
    j,
    n,
    one_torch_thread,
    perturb_zeros,
    port_discriminator,
    port_generator,
    rand,
    t,
)

SIZE, N_IMG, BATCH = 16, 3, 2
JG, JD = GeneratorConfig(size=SIZE), DiscriminatorConfig(size=SIZE)
QUANTILES = dict(fisher_quantile=40.0, prune_quantile=10.0)
NEAR_TIE = 0.02


def _d_kink_margin(d, inputs) -> float:
    """The smallest |pre-activation| of D's leaky ReLUs over `inputs`."""
    margins = []

    def hook(mod, inp, out):
        margins.append(float((inp[0] + mod.bias.reshape(1, -1, 1, 1)).abs().min()))

    handles = [m.register_forward_hook(hook) for m in d.convs.modules() if isinstance(m, FusedLeakyReLU)]
    with torch.no_grad():
        for x in inputs:
            d(x)
    for h in handles:
        h.remove()
    return min(margins)


@pytest.fixture(scope="module")
def models():
    g = perturb_zeros(generator_init(jax.random.key(3), JG), 300)
    d = perturb_zeros(discriminator_init(jax.random.key(4), JD), 400)
    noises, reals = rand((N_IMG, 512), 6), rand((N_IMG, 3, SIZE, SIZE), 11)
    pg, pd = port_generator(JG, g), port_discriminator(JD, d)
    # A pre-activation within rounding of the leaky-ReLU kink takes either
    # slope, and with one image per gradient that moves every gradient
    # upstream of it by up to tens of percent.  These inputs keep the style
    # MLP's pre-activations 1e-5 or more from the kink, and D's 2e-6 or more
    # (on the real and the generated images; the convs' rounding is ~1e-7).
    with torch.no_grad():
        x = pixel_norm(t(noises))
        for layer in pg.style[1:]:
            pre = torch.nn.functional.linear(x, layer.weight * layer.scale) + layer.bias * layer.lr_mul
            assert float(pre.abs().min()) > 1e-5
            x = layer(x)
        fakes = [pg([t(noises[i : i + 1])])[0] for i in range(N_IMG)]
    assert _d_kink_margin(pd, fakes + [t(reals[i : i + 1]) for i in range(N_IMG)]) > 2e-6
    return g, d, pg, pd, noises, reals


@pytest.fixture(scope="module")
def jax_fims(models):
    g, d, _, _, noises, reals = models
    fg, fd = jf.accumulate_fims(JG, JD, g, d, j(noises), j(reals), jax.random.key(0), batch=BATCH, const_noise=True)
    return generator_state_dict_from_jax(JG, fg), discriminator_state_dict_from_jax(JD, fd), (fg, fd)


def test_accumulate_fims_const_noise_matches_jax(models, jax_fims):
    _, _, pg, pd, noises, reals = models
    want_g, want_d, _ = jax_fims
    got_g, got_d = accumulate_fims(pg, pd, t(noises), t(reals), batch=BATCH, const_noise=True)
    assert set(got_g) == {k for k, _ in pg.named_parameters()}
    assert set(got_d) == set(want_d)
    # squared gradients of a G and D forward and backward, summed in another
    # order on each side: 1e-4 relative, plus 2e-5 of the tensor's largest
    for got, want in ((got_g, want_g), (got_d, want_d)):
        for k, v in got.items():
            close(v, want[k].reshape(v.shape), rtol=1e-4, atol_frac=2e-5)


def test_accumulate_fims_denom_scales_and_fresh_noise_differs(models):
    _, _, pg, pd, noises, reals = models
    a, _ = accumulate_fims(pg, pd, t(noises[:1]), t(reals[:1]), batch=2, const_noise=True)
    b, _ = accumulate_fims(pg, pd, t(noises[:1]), t(reals[:1]), batch=2, denom=8.0, const_noise=True)
    k = "convs.0.conv.weight"
    close(a[k], n(b[k]) * 4.0, rtol=1e-6, atol_frac=0)  # default denom = N * batch = 2
    c, _ = accumulate_fims(pg, pd, t(noises[:1]), t(reals[:1]), batch=2, gen=torch.Generator().manual_seed(0))
    assert not torch.allclose(a[k], c[k])


def _scores_np(fg, fd):
    """Per mask key: (score, freeze cut, prune cut), in numpy, as
    rick_tpu's masks_from_fims groups them."""
    out = {}
    n_g = sum(1 for k in fg if k.startswith("convs.") and k.endswith(".conv.weight"))
    conv = [fg[f"convs.{i}.conv.weight"].reshape(fg[f"convs.{i}.conv.weight"].shape[-4:]).mean(axis=(1, 2, 3))
            for i in range(n_g)]
    fc = [(fg[f"convs.{i}.conv.modulation.weight"].mean(axis=1) + fg[f"convs.{i}.conv.modulation.bias"]) / 2
          for i in range(n_g)]
    for scores, keys in ((conv, ["conv.weight"]), (fc, ["conv.modulation.weight", "conv.modulation.bias"])):
        cuts = np.percentile(np.concatenate(scores), [QUANTILES["fisher_quantile"], QUANTILES["prune_quantile"]])
        for i, s in enumerate(scores):
            for key in keys:
                out[f"convs.{i}.{key}"] = (s, *cuts)
    d_scores = {}
    for b in range(1, 1 + sum(1 for k in fd if k.endswith(".conv1.0.weight"))):
        s1 = (fd[f"convs.{b}.conv1.0.weight"].mean(axis=(1, 2, 3)) + fd[f"convs.{b}.conv1.1.bias"]) / 2
        s2 = (fd[f"convs.{b}.conv2.1.weight"].mean(axis=(1, 2, 3)) + fd[f"convs.{b}.conv2.2.bias"]) / 2
        sk = fd[f"convs.{b}.skip.1.weight"].mean(axis=(1, 2, 3))
        d_scores.update({f"convs.{b}.conv1.0.weight": s1, f"convs.{b}.conv1.1.bias": s1,
                         f"convs.{b}.conv2.1.weight": s2, f"convs.{b}.conv2.2.bias": s2,
                         f"convs.{b}.skip.1.weight": sk})
    uniq = [d_scores[k] for k in d_scores if not k.endswith(("conv1.1.bias", "conv2.2.bias"))]
    cuts = np.percentile(np.concatenate(uniq), [QUANTILES["fisher_quantile"], QUANTILES["prune_quantile"]])
    out.update({k: (s, *cuts) for k, s in d_scores.items()})
    return out


def _compare_masks(got, want, scores, near):
    """Masks equal on every filter whose score is more than `near` (relative)
    from both cutlines; returns the number of filters compared."""
    compared = 0
    for k, w in want.items():
        s, cut, prune = scores[k]
        far = (np.abs(s - cut) > near * abs(cut)) & (np.abs(s - prune) > near * abs(prune))
        np.testing.assert_array_equal(n(got[k])[far], w[far], err_msg=k)
        compared += int(far.sum())
    return compared


CONVERT = (g_masks_from_jax, g_masks_from_jax, d_masks_from_jax, d_masks_from_jax)


def test_masks_from_same_fims_match_jax(jax_fims):
    fg_np, fd_np, (fg, fd) = jax_fims
    want = jf.masks_from_fims(fg, fd, **QUANTILES)
    got = masks_from_fims({k: t(v) for k, v in fg_np.items()}, {k: t(v) for k, v in fd_np.items()}, **QUANTILES)
    scores = _scores_np(fg_np, fd_np)
    compared = total = 0
    for g_, w_, conv in zip(got, want, CONVERT):
        w_ = conv(w_)
        assert set(g_) == set(w_)
        # the same scores on both sides: only a score within rounding of a
        # cutline (1e-6) may fall on the other side
        compared += _compare_masks(g_, w_, scores, 1e-6)
        total += sum(v.size for v in w_.values())
    assert compared > 0.99 * total


def test_fisher_round_matches_jax(models, jax_fims):
    """End to end: the port's FIMs and masks against rick_tpu's FIMs (with
    the constant noise: rick_tpu's fisher_round draws fresh noise) and
    masks."""
    _, _, pg, pd, noises, reals = models
    fg_np, fd_np, (fg, fd) = jax_fims
    want = jf.masks_from_fims(fg, fd, **QUANTILES)
    got = fisher_round(pg, pd, t(noises), t(reals), batch=BATCH, const_noise=True, **QUANTILES)
    scores = _scores_np(fg_np, fd_np)
    for g_, w_, conv in zip(got, want, CONVERT):
        _compare_masks(g_, conv(w_), scores, NEAR_TIE)


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_from_random_fims_match_jax(seed):
    """Random FIMs at the 16px shapes, so that the percentiles fall between
    distinct values, not on ties."""
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda x: rng.random(np.shape(x)).astype(np.float32), generator_init(jax.random.key(0), JG))
    d = jax.tree.map(lambda x: rng.random(np.shape(x)).astype(np.float32), discriminator_init(jax.random.key(1), JD))
    want = jf.masks_from_fims(g, d, **QUANTILES)
    fg_np, fd_np = generator_state_dict_from_jax(JG, g), discriminator_state_dict_from_jax(JD, d)
    got = masks_from_fims({k: t(v) for k, v in fg_np.items()}, {k: t(v) for k, v in fd_np.items()}, **QUANTILES)
    scores = _scores_np(fg_np, fd_np)
    for g_, w_, conv in zip(got, want, CONVERT):
        _compare_masks(g_, conv(w_), scores, 1e-6)
