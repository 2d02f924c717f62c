"""The port's G/D forward slice against `rick_tpu` on the same weights and
inputs: converted `generator_init` / `discriminator_init` params (biases and
noise weights made random), latents and noise from numpy.  f32 on both sides:
rtol 1e-4, atol 1e-4 * max|ref|.  Also the stored goldens, the checkpoint
round trip from `rick_tpu.ckpt`, sample grids and image saving."""

import os

import jax
import numpy as np
import pytest
import torch

from rick_tpu.nn import (
    DiscriminatorConfig,
    GeneratorConfig,
    discriminator_apply,
    discriminator_init,
    generator_apply,
    generator_init,
    style_forward,
)
from rick_tpu_torch import ops
from rick_tpu_torch.ckpt import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    load_checkpoint,
    merge_state_dict_lenient,
)
from rick_tpu_torch.nn import Discriminator, Generator
from rick_tpu_torch.train import sample_images
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

RTOL, ATOL_FRAC = 1e-4, 1e-4
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _g(size):
    cfg = GeneratorConfig(size=size)
    params = perturb_zeros(generator_init(jax.random.key(0), cfg), 100)
    return cfg, params, port_generator(cfg, params)


def _d(size):
    cfg = DiscriminatorConfig(size=size)
    params = perturb_zeros(discriminator_init(jax.random.key(2), cfg), 200)
    return cfg, params, port_discriminator(cfg, params)


@pytest.mark.parametrize("size", [32, 64])
def test_generator_image_and_latents(size):
    cfg, params, g = _g(size)
    z = rand((2, cfg.style_dim), 1)
    want_img, want_lat = generator_apply(cfg, params, [j(z)], return_latents=True)
    with torch.no_grad():
        img, lat = g([t(z)], return_latents=True)
    assert img.shape == (2, 3, size, size)
    close(img, want_img, rtol=RTOL, atol_frac=ATOL_FRAC)
    close(lat, want_lat, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_generator_mixing_and_feats():
    cfg, params, g = _g(32)
    z1, z2 = rand((2, cfg.style_dim), 3), rand((2, cfg.style_dim), 4)
    want_img, want_feats = generator_apply(cfg, params, [j(z1), j(z2)], inject_index=3, return_feats=True)
    with torch.no_grad():
        img, feats = g([t(z1), t(z2)], inject_index=3, return_feats=True)
    close(img, want_img, rtol=RTOL, atol_frac=ATOL_FRAC)
    assert len(feats) == len(want_feats) == cfg.num_layers
    for got, want in zip(feats, want_feats):
        close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_generator_truncation_and_explicit_noise():
    cfg, params, g = _g(32)
    z = rand((2, cfg.style_dim), 5)
    mean = np.asarray(style_forward(cfg, params, j(rand((64, cfg.style_dim), 6)))).mean(0, keepdims=True)
    noise = [rand((2, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)), 10 + i) for i in range(cfg.num_layers)]
    want, _ = generator_apply(cfg, params, [j(z)], truncation=0.7, truncation_latent=j(mean),
                              noise=[j(x) for x in noise])
    with torch.no_grad():
        got, _ = g([t(z)], truncation=0.7, truncation_latent=t(mean), noise=[t(x) for x in noise])
    close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_generator_per_sample_inject_index_and_input_is_latent():
    cfg, params, g = _g(16)
    w1, w2 = rand((3, cfg.style_dim), 7), rand((3, cfg.style_dim), 8)
    idx = np.array([1, 4, 6], np.int32)
    want, want_lat = generator_apply(cfg, params, [j(w1), j(w2)], inject_index=j(idx).astype(np.int32),
                                     input_is_latent=True, return_latents=True)
    with torch.no_grad():
        got, lat = g([t(w1), t(w2)], inject_index=torch.from_numpy(idx), input_is_latent=True,
                     return_latents=True)
    close(lat, want_lat, rtol=0, atol_frac=0)
    close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)


@pytest.mark.parametrize("splits", [1, 2])
def test_discriminator_score_and_feats(splits):
    cfg, params, d = _d(32)
    x = rand((4, 3, 32, 32), 9)
    want_s, want_f = discriminator_apply(cfg, params, j(x), stddev_splits=splits)
    with torch.no_grad():
        s, feats = d(t(x), stddev_splits=splits)
    assert s.shape == (4, 1)
    close(s, want_s, rtol=RTOL, atol_frac=ATOL_FRAC)
    assert len(feats) == len(want_f)
    for got, want in zip(feats, want_f):
        close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_goldens():
    """The stored JAX goldens, through converted generator_init(key(0)) and
    discriminator_init(key(2)) params (tolerances of tests/test_goldens.py)."""
    gcfg = GeneratorConfig(size=32)
    g = port_generator(gcfg, generator_init(jax.random.key(0), gcfg))
    z = np.asarray(jax.random.normal(jax.random.key(1), (2, 512)))
    dcfg = DiscriminatorConfig(size=32)
    d = port_discriminator(dcfg, discriminator_init(jax.random.key(2), dcfg))
    with torch.no_grad():
        img, _ = g([t(z)])
        score, _ = d(img)
    np.testing.assert_allclose(n(img), np.load(os.path.join(GOLDENS, "g32_fixed.npy")), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(score), np.load(os.path.join(GOLDENS, "d32_scores.npy")), rtol=1e-3, atol=1e-4)


def test_converters_equal_rick_tpu_key_for_key():
    from rick_tpu.ckpt import discriminator_state_dict_from_params, generator_state_dict_from_params

    gcfg, dcfg = GeneratorConfig(size=16), DiscriminatorConfig(size=16)
    gp, dp = generator_init(jax.random.key(3), gcfg), discriminator_init(jax.random.key(4), dcfg)
    for ours, theirs in [
        (generator_state_dict_from_jax(gcfg, gp), generator_state_dict_from_params(gcfg, gp)),
        (discriminator_state_dict_from_jax(dcfg, dp), discriminator_state_dict_from_params(dcfg, dp)),
    ]:
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].dtype == np.float32 and ours[k].shape == theirs[k].shape, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_checkpoint_from_rick_tpu_loads_into_the_port(tmp_path):
    """A 5-key `.pt` written by rick_tpu's trainer (save_torch_file) loads with
    load_checkpoint, and the loaded g_ema and d give rick_tpu's outputs."""
    from rick_tpu.ckpt import (
        discriminator_state_dict_from_params,
        generator_state_dict_from_params,
        save_torch_file,
    )
    from rick_tpu.cli.train import _save_torch_ckpt
    from rick_tpu.train import TrainConfig, init_train_state

    gcfg, dcfg = GeneratorConfig(size=16), DiscriminatorConfig(size=16)
    state = jax.device_get(init_train_state(jax.random.key(0), gcfg, dcfg, TrainConfig(batch=2, augment=False)))
    path = str(tmp_path / "ck.pt")
    _save_torch_ckpt(path, gcfg, dcfg, TrainConfig(batch=2, augment=False), state, save_torch_file,
                     generator_state_dict_from_params, discriminator_state_dict_from_params)

    fresh = dict(rng=torch.Generator().manual_seed(9))
    g, g_ema, d = Generator(16, **fresh), Generator(16, **fresh), Discriminator(16, **fresh)
    ckpt = load_checkpoint(path, "cpu", g=g, g_ema=g_ema, d=d)
    assert set(ckpt) == {"g", "g_ema", "d", "g_optim", "d_optim"}

    z, x = rand((2, 512), 11), rand((2, 3, 16, 16), 12)
    want_img, _ = generator_apply(gcfg, state["g_ema"], [j(z)])
    want_s, _ = discriminator_apply(dcfg, state["d"], j(x))
    with torch.no_grad():
        img, _ = g_ema.eval()([t(z)])
        s, _ = d.eval()(t(x))
    close(img, want_img, rtol=RTOL, atol_frac=ATOL_FRAC)
    close(s, want_s, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_lenient_merge_ignores_unknown_keys_and_skips_wrong_shapes():
    g = Generator(8, 16, 2, rng=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in g.state_dict().items()}
    new_bias = torch.full_like(before["conv1.activate.bias"], 0.25)
    sd = {
        "conv1.activate.bias": new_bias,
        "input.input": torch.zeros(1, 7, 4, 4),  # wrong shape: skipped
        "not.a.key": torch.zeros(3),
    }
    with pytest.warns(UserWarning, match="input.input"):
        merge_state_dict_lenient(g, sd)
    after = g.state_dict()
    assert torch.equal(after["conv1.activate.bias"], new_bias)
    assert torch.equal(after["input.input"], before["input.input"])
    assert all(torch.equal(after[k], before[k]) for k in before if k != "conv1.activate.bias")


def test_sample_images_chunks_match_rick_tpu():
    cfg, params, g = _g(16)
    z = rand((5, cfg.style_dim), 13)
    grid = sample_images(g, t(z), chunk=2)
    want, _ = generator_apply(cfg, params, [j(z)])
    assert grid.shape == (5, 3, 16, 16)
    close(grid, want, rtol=RTOL, atol_frac=ATOL_FRAC)


def test_save_image_grid_matches_rick_tpu(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    from rick_tpu.utils.images import save_image_grid as j_save
    from rick_tpu_torch.utils import save_image_grid

    imgs = rand((5, 3, 8, 8), 14)
    save_image_grid(t(imgs), str(tmp_path / "port.png"), nrow=3)
    j_save(imgs, str(tmp_path / "jax.png"), nrow=3)
    a, b = np.asarray(Image.open(tmp_path / "port.png")), np.asarray(Image.open(tmp_path / "jax.png"))
    assert a.shape == (2 * 10 + 2, 3 * 10 + 2, 3)
    np.testing.assert_array_equal(a, b)


def test_cpu_slice_launches_no_kernel():
    ops.reset_launch_counts()
    g = Generator(16, 32, 2, rng=torch.Generator().manual_seed(0))
    d = Discriminator(16, rng=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        img, _ = g([torch.randn(2, 32, generator=torch.Generator().manual_seed(2))],
                   rng=torch.Generator().manual_seed(3))
        d(img)
        g.mean_latent(8, torch.Generator().manual_seed(4))
    assert ops.launch_counts() == {
        "fused_bias_act": 0, "fused_bias_act_bwd": 0, "modconv_epilogue": 0, "convt_blur_act": 0, "modconv_act": 0,
        "filtered_lrelu_act": 0,
    }
