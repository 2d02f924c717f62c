"""The port's legacy helpers (`rick_tpu_torch.legacy`) against
`rick_tpu.legacy` on the same numpy inputs, on the CPU.

* slerp, conditional batch and instance norm at 1e-6 relative;
* spectral norm's w / sigma and u at 1e-5 for 1 and 5 power iterations,
  and its gradient path;
* the FiLM decompose / compose and `strip_module_prefix` bitwise;
* `get_dataset`: 'image' (PNG, JPEG) bitwise with flip=False where no
  resize acts, 'npy' bitwise with and without the same flip draws;
* a `CheckpointIO` file written by each package and loaded by the other;
* the samplers (torch.Generator draws, not jax.random's) by shape, range
  and moments;
* `Logger`, `get_parameter_number`, `save_feature_map`, `update_average`.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rick_tpu.legacy as J
import rick_tpu_torch.legacy as P
from rick_tpu.legacy import film as j_film
from rick_tpu.legacy import inputs as j_inputs
from rick_tpu.legacy import model_utils as j_mu
from rick_tpu_torch.data.png import decode_png
from rick_tpu_torch.legacy import film as p_film
from rick_tpu_torch.legacy import inputs as p_inputs
from rick_tpu_torch.legacy import model_utils as p_mu
from tests.torch_port_helpers import close, j, n, one_torch_thread, rand, t  # noqa: F401


def test_exports_match():
    assert sorted(P.__all__) == sorted(J.__all__)


def test_interpolate_sphere():
    z1, z2 = rand((6, 16), 1), rand((6, 16), 2)
    for s in (0.0, 0.3, 0.5, 1.0):
        close(P.interpolate_sphere(t(z1), t(z2), s), J.interpolate_sphere(j(z1), j(z2), s), rtol=1e-6, atol_frac=1e-6)
    s = rand((6, 1), 3) ** 2 / 4
    close(P.interpolate_sphere(t(z1), t(z2), t(s)), J.interpolate_sphere(j(z1), j(z2), j(s)), rtol=1e-6,
          atol_frac=1e-6)


@pytest.mark.parametrize("fn", ["cbatch_norm_apply", "cinstance_norm_apply"])
def test_conditional_norms(fn):
    x = rand((4, 8, 5, 6), 4, scale=3.0) + 1.5
    g, b = rand((4, 8), 5), rand((4, 8), 6)
    close(getattr(P, fn)(t(x), t(g), t(b)), getattr(J, fn)(j(x), j(g), j(b)), rtol=1e-6, atol_frac=1e-6)


@pytest.mark.parametrize("n_iter", [1, 5])
@pytest.mark.parametrize("shape", [(8, 12), (16, 8, 3, 3)])
def test_spectral_norm(shape, n_iter):
    w, u = rand(shape, 7), rand(shape[:1], 8)
    got_w, got_u = P.spectral_norm_apply(t(w), t(u), n_iter=n_iter)
    want_w, want_u = J.spectral_norm_apply(j(w), j(u), n_iter=n_iter)
    close(got_w, want_w, rtol=1e-5, atol_frac=1e-5)
    close(got_u, want_u, rtol=1e-5, atol_frac=1e-5)
    assert not got_u.requires_grad
    # the gradient in w flows through sigma's power iterations, u stops it
    gw = rand(shape, 9)
    x = t(w).requires_grad_(True)
    (got_g,) = torch.autograd.grad((P.spectral_norm_apply(x, t(u), n_iter=n_iter)[0] * t(gw)).sum(), x)
    want_g = jax.grad(lambda a: jnp.sum(J.spectral_norm_apply(a, j(u), n_iter=n_iter)[0] * j(gw)))(j(w))
    close(got_g, want_g, rtol=1e-4, atol_frac=1e-4)


def test_spectral_norm_converges_to_unit_sigma():
    w, u = t(rand((8, 12), 0)), t(rand((8,), 1))
    for _ in range(30):
        wn, u = P.spectral_norm_apply(w, u)
    np.testing.assert_allclose(np.linalg.svd(n(wn), compute_uv=False)[0], 1.0, rtol=1e-3)


def _film_sd():
    return {
        "style.1.weight": rand((8, 8), 10),
        "style.2.weight": rand((8, 8), 11),
        "convs.0.conv.weight": rand((1, 4, 3, 3, 3), 12),
        "to_rgbs.0.conv.modulation.weight": rand((4, 8), 13),
        "other.bias": rand((4,), 14),
    }


@pytest.mark.parametrize("stdd", [1.0, 0.5])
def test_film_bitwise(stdd):
    sd = _film_sd()
    for dec, comp in (("decompose_film_generator", "compose_film_generator"),
                      ("decompose_film_discriminator", None)):
        got, got_f = getattr(p_film, dec)(sd, stdd)
        want, want_f = getattr(j_film, dec)(sd, stdd)
        assert got.keys() == want.keys() and got_f.keys() == want_f.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for k in want_f:
            np.testing.assert_array_equal(got_f[k], want_f[k])
        if comp:
            back, want_back = getattr(p_film, comp)(got, got_f), getattr(j_film, comp)(want, want_f)
            for k in want_back:
                np.testing.assert_array_equal(back[k], want_back[k])
    sd = {"module.a.b": 1, "c": 2, "module.": 3}
    assert p_film.strip_module_prefix(sd) == j_film.strip_module_prefix(sd)


def _image_folder(root):
    """PNGs (RGB, gray, RGBA) and JPEGs in class folders, shorter side 16."""
    rng = np.random.default_rng(20)
    for i, (h, w, mode, ext) in enumerate([(16, 24, "RGB", "png"), (24, 16, "L", "png"), (16, 16, "RGBA", "png"),
                                           (30, 16, "RGB", "jpg"), (16, 23, "RGB", "jpeg")]):
        d = root / f"c{i % 2}"
        d.mkdir(exist_ok=True)
        px = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        Image.fromarray(px[..., 0] if mode == "L" else px, mode).save(d / f"{i}.{ext}")
    (root / "c0" / "skip.txt").write_text("not an image")


def test_get_dataset_image(tmp_path):
    """At the stored size (a centre crop) the images are bitwise rick_tpu's.
    Resized, they are within one level of 255: the port's bilinear resize
    is F.interpolate where rick_tpu takes cv2's 11-bit fixed point
    (`data/loader.py`)."""
    _image_folder(tmp_path)
    for size, atol in ((16, 0.0), (8, 1 / 127.5 + 1e-6)):
        got = p_inputs.get_dataset("image", str(tmp_path), size, flip=False)
        want = j_inputs.get_dataset("image", str(tmp_path), size, flip=False)
        assert len(got) == len(want) == 5
        for i in range(len(want)):
            a, b = got.get(i, np.random.default_rng(0)), want.get(i, np.random.default_rng(0))
            assert a.dtype == b.dtype == np.float32 and a.shape == (3, size, size)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["nchw_float", "nhwc_uint8"])
def test_get_dataset_npy_bitwise(tmp_path, layout):
    rng = np.random.default_rng(21)
    arr = rng.uniform(-1, 1, (6, 3, 8, 8)).astype(np.float32)
    if layout == "nhwc_uint8":
        arr = rng.integers(0, 256, (6, 8, 8, 3)).astype(np.uint8)
    np.save(tmp_path / "x.npy", arr)
    for flip in (False, True):
        got = p_inputs.get_dataset("npy", str(tmp_path / "x.npy"), flip=flip)
        want = j_inputs.get_dataset("npy", str(tmp_path / "x.npy"), flip=flip)
        assert len(got) == len(want) == 6
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        for i in range(6):
            np.testing.assert_array_equal(got.get(i, r1), want.get(i, r2))
    with pytest.raises(NotImplementedError):
        p_inputs.get_dataset("lsun", str(tmp_path))


def test_checkpoint_io_across_packages(tmp_path):
    tree = {"w": rand((2, 3), 30), "blocks": [rand((4,), 31), rand((2, 2), 32)]}
    # the port saves tensors, a module's state dict and arrays; rick_tpu loads
    mod = torch.nn.Linear(3, 2)
    p = P.CheckpointIO(str(tmp_path / "p"))
    p.register_modules(gen={"w": t(tree["w"]), "blocks": [t(b) for b in tree["blocks"]]}, lin=mod)
    p.save("model.npz", it=42, loss=0.5)
    jio = J.CheckpointIO(str(tmp_path / "p"))
    jio.register_modules(gen=jax.tree.map(jnp.zeros_like, tree),
                         lin={"weight": jnp.zeros((2, 3)), "bias": jnp.zeros((2,))})
    manifest = jio.load("model.npz")
    assert manifest["step"] == 42 and manifest["loss"] == 0.5
    np.testing.assert_array_equal(np.asarray(jio.module_dict["gen"]["w"]), tree["w"])
    np.testing.assert_array_equal(np.asarray(jio.module_dict["gen"]["blocks"][1]), tree["blocks"][1])
    np.testing.assert_array_equal(np.asarray(jio.module_dict["lin"]["weight"]), n(mod.weight))
    # rick_tpu saves; the port loads into a module in place and a tree anew
    jio.save(str(tmp_path / "j.npz"), it=7)
    mod2 = torch.nn.Linear(3, 2)
    p2 = P.CheckpointIO(str(tmp_path / "q"))
    p2.register_modules(gen=None, lin=mod2)
    assert p2.load(str(tmp_path / "j.npz"))["step"] == 7
    assert torch.equal(mod2.weight, mod.weight) and torch.equal(mod2.bias, mod.bias)
    assert torch.equal(p2.module_dict["gen"]["blocks"][0], t(tree["blocks"][0]))
    with pytest.raises(IOError):
        p2.load("https://example.invalid/model.npz")


def test_samplers_by_distribution():
    gen = torch.Generator().manual_seed(0)
    z = P.get_zdist("gauss", 16)
    assert z.dim == 16
    x = z(gen, 20000)
    assert x.shape == (20000, 16) and x.dtype == torch.float32
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1.0) < 0.01
    u = P.get_zdist("uniform", 4)(gen, 20000)
    assert u.shape == (20000, 4) and float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.02 and abs(float(u.var()) - 1 / 3) < 0.01
    y = P.get_ydist(10)
    assert y.nlabels == 10
    labels = y(gen, 20000)
    assert labels.shape == (20000,) and int(labels.min()) == 0 and int(labels.max()) == 9
    assert np.abs(np.bincount(n(labels), minlength=10) / 20000 - 0.1).max() < 0.01
    # the same seed draws the same values
    assert torch.equal(z(torch.Generator().manual_seed(3), 5), z(torch.Generator().manual_seed(3), 5))
    with pytest.raises(NotImplementedError):
        P.get_zdist("cauchy", 2)


def test_logger(tmp_path):
    lg = P.Logger(log_dir=str(tmp_path / "log"), img_dir=str(tmp_path / "imgs"))
    lg.add("losses", "d", 0.5, it=1)
    lg.add("losses", "d", torch.tensor(0.25), it=2)
    lg.save_stats("stats.p")
    jl = J.Logger(log_dir=str(tmp_path / "log"), img_dir=str(tmp_path / "j"))
    jl.load_stats("stats.p")
    assert jl.get_last("losses", "d") == 0.25 and jl.get_last("losses", "g", 1.0) == 1.0
    imgs = np.random.default_rng(40).uniform(-1.2, 1.2, (5, 3, 6, 7)).astype(np.float32)
    lg.add_imgs(t(imgs), "cls", 3, nrow=2)
    jl.add_imgs(imgs, "cls", 3, nrow=2)
    with open(tmp_path / "imgs" / "cls" / "00000003.png", "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j" / "cls" / "00000003.png")))


def test_parameter_number():
    tree = {"a": np.zeros((3, 4)), "b": [np.zeros(5)]}
    assert P.get_parameter_number(tree) == J.get_parameter_number(tree)
    mod = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    mod[1].weight.requires_grad_(False)
    assert P.get_parameter_number(mod, "m") == {"name": "m", "Total": 26, "Trainable": 18}


def test_save_feature_map(tmp_path):
    feats = rand((2, 3, 5, 4), 41)
    P.save_feature_map(t(feats), str(tmp_path / "p.png"), nrow=4)
    J.save_feature_map(feats, str(tmp_path / "j.png"), nrow=4)
    with open(tmp_path / "p.png", "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j.png")))


def test_update_average():
    tgt, src = {"a": rand((3,), 50), "b": [rand((2, 2), 51)]}, {"a": rand((3,), 52), "b": [rand((2, 2), 53)]}
    got = p_mu.update_average(jax.tree.map(t, tgt), jax.tree.map(t, src), 0.9)
    want = j_mu.update_average(jax.tree.map(j, tgt), jax.tree.map(j, src), 0.9)
    close(got["a"], want["a"], rtol=1e-6, atol_frac=1e-6)
    close(got["b"][0], want["b"][0], rtol=1e-6, atol_frac=1e-6)
    m_t, m_s = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    w_t, w_s = m_t.weight.detach().clone(), m_s.weight.detach().clone()
    assert p_mu.update_average(m_t, m_s, 0.5) is m_t
    assert torch.allclose(m_t.weight, 0.5 * w_t + 0.5 * w_s)
