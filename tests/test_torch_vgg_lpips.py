"""The port's VGG16, LPIPS and intra-cluster LPIPS (`rick_tpu_torch.metrics`
vgg, lpips, intra_lpips) against `rick_tpu.metrics`' on the same weights.

VGG16 is `rick_tpu`'s `vgg16_init(seed=51)`, built once for the module and
carried across by `ckpt.vgg16_state_dict_from_jax`; the 'lin' weights are
seeded numpy arrays, handed to both sides or written with `torch.save` in
both of lpips' key layouts.  Images are seeded numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.metrics import intra_lpips as j_intra
from rick_tpu.metrics import lpips as j_lpips
from rick_tpu.metrics.vgg import vgg16_fc2_features as j_fc2
from rick_tpu.metrics.vgg import vgg16_init as j_vgg16_init
from rick_tpu_torch.ckpt import vgg16_state_dict_from_jax
from rick_tpu_torch.metrics import (
    IntraLPIPS,
    default_lin_weights,
    default_vgg16_params,
    load_cluster_centers,
    load_lpips_lin_weights,
    lpips_distance,
    prepare_cluster_centers,
    vgg16_fc2_features,
    vgg16_from_params,
    vgg16_init,
)
from rick_tpu_torch.metrics.intra_lpips import reference_preprocess
from rick_tpu_torch.metrics.lpips import _TAP_CHANNELS, vgg_taps
from rick_tpu_torch.metrics.vgg import PARAM_SHAPES
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    jvgg = j_vgg16_init(seed=51)
    sd = vgg16_state_dict_from_jax(jvgg)
    rng = np.random.default_rng(52)
    lins = [(rng.random(c) * 0.1).astype(np.float32) for c in _TAP_CHANNELS]
    return dict(jvgg=jvgg, sd=sd, vgg=vgg16_from_params(sd, device="cpu"), lins=lins)


def test_fc2_features_match_rick_tpu(weights):
    """Batch 2 from 32px inputs (nearest resize to 224, the convs, fc1, fc2):
    f32 on both sides, 1e-4 of max|ref|."""
    x = _images((2, 3, 32, 32), 1)
    want = np.asarray(jax.jit(j_fc2)(weights["jvgg"], jnp.asarray(x)))
    with torch.inference_mode():
        got = vgg16_fc2_features(weights["vgg"], torch.from_numpy(x))
    assert got.shape == (2, 4096)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("size", [32, 64])
def test_lpips_taps_match_rick_tpu(weights, size):
    """The five taps (relu1_2 ... relu5_3) after the lpips scaling layer:
    1e-5 of each tap's max|ref|."""
    x = _images((2, 3, size, size), size)
    want = jax.jit(j_lpips._vgg_taps)(weights["jvgg"], jnp.asarray(x))
    with torch.inference_mode():
        got = vgg_taps(weights["vgg"], torch.from_numpy(x))
    assert [t.shape[1] for t in got] == _TAP_CHANNELS
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-5


@pytest.mark.parametrize("layout", ["lin{i}.model.1.weight", "lins.{i}.model.1.weight"])
def test_lpips_distance_matches_rick_tpu(weights, layout, tmp_path, monkeypatch):
    """lin weights from a `torch.save`d lpips file in each key layout, read
    by each package through RICK_LPIPS_WEIGHTS: the weights equal, LPIPS of
    3 pairs at 32px within 1e-5 of max|ref|."""
    path = tmp_path / "lpips_vgg.pth"
    torch.save({layout.format(i=i): torch.from_numpy(w).reshape(1, -1, 1, 1) for i, w in enumerate(weights["lins"])},
               path)
    monkeypatch.setenv("RICK_LPIPS_WEIGHTS", str(path))
    lins, j_lins = default_lin_weights(), j_lpips.default_lin_weights()
    for a, b, w in zip(lins, j_lins, weights["lins"]):
        np.testing.assert_array_equal(a.numpy(), w)
        np.testing.assert_array_equal(np.asarray(b), w)
    x0, x1 = _images((3, 3, 32, 32), 3), _images((3, 3, 32, 32), 4)
    want = np.asarray(j_lpips.lpips_distance(jnp.asarray(x0), jnp.asarray(x1), vgg_params=weights["jvgg"],
                                             lin_weights=j_lins))
    with torch.inference_mode():
        got = lpips_distance(torch.from_numpy(x0), torch.from_numpy(x1), vgg=weights["vgg"], lin_weights=lins)
    assert got.shape == (3,) and _rel_err(got, want) <= 1e-5


def test_lin_weights_without_the_file_are_uniform_or_raise(tmp_path, monkeypatch):
    monkeypatch.delenv("RICK_LPIPS_WEIGHTS", raising=False)
    for w, c in zip(default_lin_weights(), _TAP_CHANNELS):
        assert torch.equal(w, torch.full((c,), 1.0 / c))
    torch.save({"lin0.model.1.weight": torch.ones(1, 64, 1, 1)}, tmp_path / "partial.pth")
    with pytest.raises(KeyError, match="lin1"):
        load_lpips_lin_weights(str(tmp_path / "partial.pth"))
    monkeypatch.setenv("RICK_LPIPS_WEIGHTS", str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError):
        default_lin_weights()
    monkeypatch.setenv("RICK_VGG16_WEIGHTS", str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError):
        default_vgg16_params()


def test_vgg16_state_dict_from_jax_checks_names_and_shapes(weights):
    sd = weights["sd"]
    assert {k: v.shape for k, v in sd.items()} == PARAM_SHAPES
    assert all(v.dtype == np.float32 for v in sd.values())
    with pytest.raises(KeyError, match="classifier.3.bias"):
        vgg16_state_dict_from_jax({k: v for k, v in sd.items() if k != "classifier.3.bias"})
    with pytest.raises(ValueError, match="features.0.weight"):
        vgg16_state_dict_from_jax({**sd, "features.0.weight": np.zeros((64, 3, 5, 5), np.float32)})


def test_vgg16_init_is_seeded_with_rick_tpus_shapes_and_scales():
    a, b = vgg16_init(seed=5), vgg16_init(seed=5)
    assert {k: tuple(v.shape) for k, v in a.items()} == PARAM_SHAPES
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["features.28.weight"].std()) / np.sqrt(2.0 / (512 * 9)) - 1) < 0.01
    assert abs(float(a["classifier.0.weight"].std()) / 0.01 - 1) < 0.01
    assert not any(float(v.abs().max()) for k, v in a.items() if k.endswith(".bias"))


@pytest.mark.parametrize("src,size", [(32, 32), (64, 32), (32, 64)])
def test_reference_preprocess_matches_rick_tpu(src, size):
    """The uint8 quantization bitwise; the antialiased bilinear resize
    against jax.image.resize within 1e-6."""
    x = _images((2, 3, src, src), src + size)
    x[0, 0, 0, :3] = [-1.0, 1.0, 0.0]  # the ends, and 0 -> 127.5, a tie that rounds to even
    got = reference_preprocess(x, size).numpy()
    want = j_intra.reference_preprocess(x, size)
    assert got.shape == want.shape == (2, 3, size, size)
    if src == size:
        np.testing.assert_array_equal(got, want)
    else:
        assert float(np.max(np.abs(got - want))) <= 1e-6


@pytest.mark.parametrize("preprocess", [True, False])
def test_intra_lpips_matches_rick_tpu(weights, preprocess):
    """12 images near 3 centers, clusters cut to 3 members by the same numpy
    shuffle: the labels equal, the value within 1e-5 of it.  With
    preprocess, 48px inputs are quantized and resized to 32."""
    src = 48 if preprocess else 32
    rng = np.random.default_rng(7)
    centers = _images((3, 3, src, src), 8)
    imgs = np.clip(centers[np.arange(12) % 3] + rng.normal(0, 0.2, (12, 3, src, src)), -1, 1).astype(np.float32)
    kw = dict(cluster_size=3, batch=4, preprocess=preprocess, size=32, lin_weights=weights["lins"])
    j_il = j_intra.IntraLPIPS(centers, vgg_params=weights["jvgg"], **kw)
    il = IntraLPIPS(centers, vgg_params=weights["sd"], device="cpu", **kw)
    labels = il.assign(imgs)
    np.testing.assert_array_equal(labels, j_il.assign(imgs))
    assert len(set(labels.tolist())) > 1
    want = j_il.compute(imgs, rng=np.random.default_rng(0))
    got = il.compute(imgs, rng=np.random.default_rng(0))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_cluster_centers_round_trip_across_the_packages(tmp_path):
    """Either package's `prepare_cluster_centers` is read back by the other's
    `load_cluster_centers` as the same pixels, within the uint8 step of the
    images."""
    imgs = _images((3, 3, 16, 16), 9)
    prepare_cluster_centers(imgs, str(tmp_path / "port"))
    j_intra.prepare_cluster_centers(imgs, str(tmp_path / "jax"))
    for k in range(3):
        assert (tmp_path / "port" / f"c{k}" / "center.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    from_port = j_intra.load_cluster_centers(str(tmp_path / "port"), k=3, size=16)
    from_jax = load_cluster_centers(str(tmp_path / "jax"), k=3, size=16)
    np.testing.assert_array_equal(from_port, from_jax)
    np.testing.assert_array_equal(load_cluster_centers(str(tmp_path / "port"), k=3, size=16), from_port)
    assert float(np.max(np.abs(from_port - imgs))) <= 1.0 / 127.5
