"""The port's ADA augmentation (`rick_tpu_torch.augment`) against
`rick_tpu.augment` on the CPU.

* the samplers: the port's composers fed the raw draws JAX makes from its
  keys, against `rick_tpu`'s `sample_affine` / `sample_color`; p = 0 gives
  identities; the port's own sampler's distribution;
* the reflect pad (bitwise), the bilinear sampler on the same 2x image and
  coordinates, and `apply_affine` with its gradient, against `rick_tpu`
  under its default lowering (`matmul_fir`) and its `gather` lowering;
* the footprint tail: a zoom-out beyond 2x, where `rick_tpu`'s two
  lowerings part and the port follows `gather`;
* `apply_color` and `augment` with given matrices.

Sizes: 16px at margin 44 (`size // 2 + size // 4 + 32`, ada.py's rule),
32px at margin 24, and 16px at the recipe's margin 224.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.augment import ada as j_ada
from rick_tpu_torch.augment import ada
from tests.torch_port_helpers import close, j, n, one_torch_thread, rand, t  # noqa: F401

CASES = [(16, 44), (32, 24), (16, 224)]  # (size, margin)


def j_apply_affine(margin: int):
    """rick_tpu's apply_affine, jitted as its train step runs it; traced anew
    per call, so RICK_ADA_WARP is read then."""
    return jax.jit(functools.partial(j_ada.apply_affine, margin=margin))


def j_apply_affine_grad(margin: int):
    """jax.grad of sum(apply_affine(x, G) * w) in x, jitted."""
    return jax.jit(jax.grad(lambda x, G, w: jnp.sum(j_ada.apply_affine(x, G, margin=margin) * w)))


def _uniform_select(keys, idx, p, size):
    """The uniforms behind `_random_apply`'s Bernoulli draws of keys[idx],
    after asserting that `bernoulli(k, p, s)` is `uniform(k, s) < p`."""
    us = []
    for i, pp in idx:
        u = jax.random.uniform(keys[i], (size,), jnp.float32)
        np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(keys[i], pp, (size,))), np.asarray(u < pp))
        us.append(np.asarray(u))
    return t(np.stack(us))


def jax_affine_draws(key, p, size: int) -> dict:
    """`rick_tpu`'s `sample_affine` draws of `key`, in the port's layout."""
    keys = jax.random.split(key, 16)
    p = jnp.float32(p)
    p_rot = 1 - jnp.sqrt(jnp.clip(1 - p, 0.0, 1.0))
    pi = math.pi
    return {
        "flip": t(jax.random.randint(keys[0], (size,), 0, 2).astype(jnp.float32)),
        "rot90": t(jax.random.randint(keys[2], (size,), 0, 2).astype(jnp.float32)),
        "translate": t(jax.random.uniform(keys[4], (size,), minval=-0.125, maxval=0.125)),
        "scale": t(jax.random.normal(keys[6], (size,))),
        "pre_rotate": t(jax.random.uniform(keys[8], (size,), minval=-pi, maxval=pi)),
        "aniso": t(jax.random.normal(keys[10], (size,))),
        "post_rotate": t(jax.random.uniform(keys[12], (size,), minval=-pi, maxval=pi)),
        "frac_translate": t(jax.random.normal(keys[14], (size,))),
        "select": _uniform_select(keys, [(1, p), (3, p), (5, p), (7, p), (9, p_rot), (11, p), (13, p_rot), (15, p)],
                                  p, size),
    }


def jax_color_draws(key, p, size: int) -> dict:
    """`rick_tpu`'s `sample_color` draws of `key`, in the port's layout."""
    keys = jax.random.split(key, 10)
    p = jnp.float32(p)
    return {
        "brightness": t(jax.random.normal(keys[0], (size,))),
        "contrast": t(jax.random.normal(keys[2], (size,))),
        "luma_flip": t(jax.random.randint(keys[4], (size,), 0, 2).astype(jnp.float32)),
        "hue": t(jax.random.uniform(keys[6], (size,), minval=-math.pi, maxval=math.pi)),
        "saturation": t(jax.random.normal(keys[8], (size,))),
        "select": _uniform_select(keys, [(1, p), (3, p), (5, p), (7, p), (9, p)], p, size),
    }


def jax_transform(key, p, size: int, height: int, width: int):
    """The matrices `rick_tpu`'s `augment(key, ...)` draws, as the port's
    composers build them from JAX's draws: (G, C) as torch tensors."""
    kg, kc = jax.random.split(key)
    p_t = torch.tensor(p, dtype=torch.float32)
    return (ada.affine_from_draws(jax_affine_draws(kg, p, size), p_t, height, width),
            ada.color_from_draws(jax_color_draws(kc, p, size), p_t))


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_samplers_from_jax_draws_match_rick_tpu(p):
    """The composers on JAX's draws against `sample_affine` / `sample_color`:
    a chain of eight (five) 3x3 (4x4) products of O(1) entries, 1e-6 of
    max|ref| and 1e-6 relative."""
    size = 64
    for seed in range(3):
        kg, kc = jax.random.split(jax.random.key(100 + seed))
        want_g = j_ada.sample_affine(kg, jnp.float32(p), size, 256, 256)
        got_g = ada.affine_from_draws(jax_affine_draws(kg, p, size), torch.tensor(p), 256, 256)
        close(got_g, want_g, rtol=1e-6, atol_frac=1e-6)
        want_c = j_ada.sample_color(kc, jnp.float32(p), size)
        got_c = ada.color_from_draws(jax_color_draws(kc, p, size), torch.tensor(p))
        close(got_c, want_c, rtol=1e-6, atol_frac=1e-6)


def test_p0_samples_identities_exactly():
    gen = torch.Generator().manual_seed(0)
    p = torch.zeros(())
    assert torch.equal(ada.sample_affine(gen, p, 8, 32, 32), torch.eye(3).repeat(8, 1, 1))
    assert torch.equal(ada.sample_color(gen, p, 8), torch.eye(4).repeat(8, 1, 1))


def test_sampler_distribution_properties():
    """As `tests/test_augment.py` checks rick_tpu's: at p = 0.5 only the flip
    makes det < 0, so P(det < 0) = p / 2; at p = 1 every G differs from I,
    and the rotations fire with 1 - sqrt(1 - p); the footprint tail is
    rare."""
    gen = torch.Generator().manual_seed(7)
    G = n(ada.sample_affine(gen, torch.tensor(0.5), 2000, 256, 256))
    assert abs((np.linalg.det(G) < 0).mean() - 0.25) < 0.05
    G1 = n(ada.sample_affine(gen, torch.tensor(1.0), 256, 256, 256))
    assert (np.abs(G1 - np.eye(3)).max(axis=(1, 2)) > 1e-3).all()
    draws = ada.affine_draws(gen, 4000)
    p_rot = 1 - math.sqrt(1 - 0.5)
    assert abs(float((draws["select"][4] < p_rot).float().mean()) - p_rot) < 0.03
    assert float(draws["translate"].abs().max()) <= 0.125
    assert float(draws["pre_rotate"].abs().max()) <= math.pi
    # how often a p = 1 draw shrinks the image beyond matmul_fir's footprint
    # (|a| + |b| of a row of G^-1 above 2 sqrt 2), where it and the port part
    inv = ada._inv3(ada.sample_affine(gen, torch.tensor(1.0), 100_000, 256, 256))
    reach = inv[:, :2, :2].abs().sum(-1).amax(-1)
    assert float((reach > 2 * math.sqrt(2)).float().mean()) < 2e-4


# ---------------------------------------------------------------------------
# the warp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,pad", [(16, 3), (16, 50), (7, 30), (1, 4), (16, 230)])
def test_reflect101_pad_is_rick_tpus_bitwise(size, pad):
    """Pads of at least the size included, where F.pad would raise."""
    img = rand((2, 3, size, size + 1), size + pad)
    np.testing.assert_array_equal(n(ada._reflect101_pad(t(img), pad)), np.asarray(j_ada._reflect101_pad(j(img), pad)))


@pytest.mark.parametrize("size,margin", CASES)
def test_bilinear_sampler_matches_rick_tpu(size, margin):
    """The same 2x image and coordinates, inside and far beyond the image:
    elementwise after the same fold, 1e-6 of max|ref|."""
    H2 = 2 * (size + 2 * margin + 12) - 11
    img = rand((2, 3, H2, H2), 1)
    rng = np.random.default_rng(2)
    xs = rng.uniform(-3 * H2, 4 * H2, (2, 2 * size + 10, 2 * size + 10)).astype(np.float32)
    ys = rng.uniform(-0.6, H2 - 0.4, xs.shape).astype(np.float32)
    want = jax.vmap(j_ada._bilinear_sample_reflect)(j(img), j(xs), j(ys))
    close(ada._bilinear_sample_reflect(t(img), t(xs), t(ys)), want, rtol=0, atol_frac=1e-6)


# The grid: the port takes linspace in f64 rounded once to f32; jnp.linspace
# in f32 differs from that by up to a few ulps of the normalized coordinate,
# which the 2x image's width turns into up to ~1e-3 px, and the image's slope
# into an error of the output; the 3x3 inverses differ by ulps, and XLA
# fuses the coordinate arithmetic.  Measured against jitted rick_tpu: up to
# 9.1e-6 of max|ref| at margins 44 and 24, 3.3e-5 at 16px margin 224, for
# the images and for the gradients alike, under either lowering.
AFFINE_TOL = 1e-4


def _warp_cases(size):
    G = n(jax_transform(jax.random.key(size), 1.0, 4, size, size)[0])
    eye = np.eye(3, dtype=np.float32)
    rot = eye.copy()
    rot[:2, :2] = [[math.cos(0.3), -math.sin(0.3)], [math.sin(0.3), math.cos(0.3)]]
    rot[0, 2] = 0.1
    return np.concatenate([G, rot[None], np.diag([-1.0, 1.0, 1.0]).astype(np.float32)[None]])


@pytest.mark.parametrize("lowering", ["matmul_fir", "gather"])
@pytest.mark.parametrize("size,margin", CASES)
def test_apply_affine_matches_rick_tpu(size, margin, lowering, monkeypatch):
    """Six transforms (four p = 1 draws, a rotation with a shift, a flip)
    against rick_tpu's default lowering and its gather lowering; and the
    gradient of sum(out * w) with respect to the image against jax.grad."""
    monkeypatch.setenv("RICK_ADA_WARP", lowering)  # read by both packages
    G = _warp_cases(size)
    img, w = rand((len(G), 3, size, size), 3), rand((len(G), 3, size, size), 4)
    want = j_apply_affine(margin)(j(img), j(G))
    xt = t(img).requires_grad_(True)
    got = ada.apply_affine(xt, t(G), margin=margin)
    close(got, want, rtol=0, atol_frac=AFFINE_TOL)
    want_g = j_apply_affine_grad(margin)(j(img), j(G), j(w))
    (got_g,) = torch.autograd.grad((got * t(w)).sum(), xt)
    close(got_g, want_g, rtol=0, atol_frac=AFFINE_TOL)


@pytest.mark.parametrize("size,margin", CASES)
def test_identity_keeps_a_constant_image_and_matches_rick_tpu(size, margin):
    """G = C = I.  The chain does not give back the input: its grid is the
    reference's linspace over the 2x image read with align_corners=False, a
    zoom by W2 / (W2 - 1) with an offset, so rick_tpu moves the image by a
    fraction of a pixel there too.  What holds: a constant image comes back
    (the sym6 pair's gain is 1; 1e-5 of it), and noise goes as in rick_tpu
    (AFFINE_TOL)."""
    eye = (torch.eye(3).repeat(2, 1, 1), torch.eye(4).repeat(2, 1, 1))
    flat = np.full((2, 3, size, size), 0.75, np.float32)
    out, _ = ada.augment(t(flat), torch.tensor(0.0), margin=margin, transform=eye)
    close(out, flat, rtol=0, atol_frac=1e-5)
    img = rand((2, 3, size, size), 5)
    out, _ = ada.augment(t(img), torch.tensor(0.0), margin=margin, transform=eye)
    want = np.asarray(j_apply_affine(margin)(j(img), j(eye[0])))
    close(out, want, rtol=0, atol_frac=AFFINE_TOL)
    assert np.abs(want - img).max() > 0.1 * np.abs(img).max()  # rick_tpu's G = I moves the image too


def test_footprint_tail_follows_gather_not_matmul_fir(monkeypatch):
    """A 0.28x zoom-out: |a| + |b| of G^-1's rows is 7.1, beyond matmul_fir's
    footprint (2 sqrt 2), which clamps its taps there.  The port matches the
    gather lowering (AFFINE_TOL) and parts from matmul_fir by O(1)."""
    size, margin = 16, 44
    G = np.tile(np.diag([0.28, 0.28, 1.0]).astype(np.float32), (2, 1, 1))
    G[1, :2, :2] = 0.28 * np.array([[math.cos(0.7), -math.sin(0.7)], [math.sin(0.7), math.cos(0.7)]])
    img = rand((2, 3, size, size), 6)
    got = ada.apply_affine(t(img), t(G), margin=margin)
    monkeypatch.setenv("RICK_ADA_WARP", "gather")
    close(got, j_apply_affine(margin)(j(img), j(G)), rtol=0, atol_frac=AFFINE_TOL)
    monkeypatch.setenv("RICK_ADA_WARP", "matmul_fir")
    fir = np.asarray(j_apply_affine(margin)(j(img), j(G)))
    assert np.abs(n(got) - fir).max() > 0.1 * np.abs(fir).max()


# ---------------------------------------------------------------------------
# colour and the whole augment
# ---------------------------------------------------------------------------


def test_apply_color_matches_rick_tpu():
    img, C = rand((3, 3, 16, 16), 7), rand((3, 4, 4), 8)
    close(ada.apply_color(t(img), t(C)), j_ada.apply_color(j(img), j(C)), rtol=1e-6, atol_frac=1e-6)


@pytest.mark.parametrize("size,margin", CASES[:2])
def test_augment_with_jaxs_matrices_matches_rick_tpu(size, margin):
    """`augment(transform=(G, C))` with the matrices JAX's key draws at
    p = 0.7 against rick_tpu's `augment` of that key; the returned matrices
    are the given ones."""
    key = jax.random.key(9)
    img = rand((4, 3, size, size), 10)
    want, (jG, jC) = jax.jit(functools.partial(j_ada.augment, margin=margin))(key, j(img), jnp.float32(0.7))
    G, C = jax_transform(key, 0.7, 4, size, size)
    close(G, jG, rtol=1e-6, atol_frac=1e-6)
    close(C, jC, rtol=1e-6, atol_frac=1e-6)
    got, (g2, c2) = ada.augment(t(img), torch.tensor(0.7), margin=margin, transform=(G, C))
    assert g2 is G and c2 is C
    close(got, want, rtol=0, atol_frac=AFFINE_TOL)


def test_augment_draws_from_gen_on_its_device():
    """Without matrices, augment draws them from `gen` at p: the same seed
    gives the same images, and p = 0 draws identities."""
    img = t(rand((2, 3, 16, 16), 11))
    a, (Ga, Ca) = ada.augment(img, torch.tensor(0.8), margin=44, gen=torch.Generator().manual_seed(3))
    b, _ = ada.augment(img, torch.tensor(0.8), margin=44, gen=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and Ga.shape == (2, 3, 3) and Ca.shape == (2, 4, 4)
    _, (G0, C0) = ada.augment(img, torch.tensor(0.0), margin=44, gen=torch.Generator().manual_seed(3))
    assert torch.equal(G0, torch.eye(3).repeat(2, 1, 1)) and torch.equal(C0, torch.eye(4).repeat(2, 1, 1))
