"""The port's metric pieces (`rick_tpu_torch.metrics`: resize, inception,
fid) against `rick_tpu.metrics` on the same numpy inputs and weights.

Tolerances are relative to max|ref| and stated per test: f64 on both sides
where the point is the architecture (1e-9, only reassociation), f32 where
the point is the f32 path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.metrics import fid as j_fid
from rick_tpu.metrics import resize as j_resize
from rick_tpu.metrics.inception import inception_init_np as j_inception_init_np
from rick_tpu.metrics.inception import inception_pool3 as j_inception_pool3
from rick_tpu_torch import metrics
from rick_tpu_torch.metrics import fid
from tests.torch_port_helpers import one_torch_thread, port_inception, randomize_bn  # noqa: F401


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


@pytest.fixture(scope="module")
def incp():
    """rick_tpu's seeded Inception params with randomized batch-norm stats."""
    return randomize_bn(j_inception_init_np(5), seed=13)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), (299, 299)), ((256, 256), (299, 299)),
                                          ((300, 200), (224, 224))])
def test_bilinear_resize_matches_rick_tpu(in_hw, out_hw):
    """f64 on both sides: the same convention, within 1e-12.  f32: 1e-4,
    because torch computes the source coordinate in the input's dtype (up to
    ~1.5e-5 of a pixel at 299) where rick_tpu builds its matrix in f64."""
    x = np.random.default_rng(0).standard_normal((2, 3, *in_hw))
    got = metrics.bilinear_resize_torch(torch.from_numpy(x), *out_hw)
    with jax.enable_x64(True):
        want = np.asarray(j_resize.bilinear_resize_torch(jnp.asarray(x), *out_hw))
    assert got.shape == want.shape and _rel_err(got, want) <= 1e-12
    x = x.astype(np.float32)
    got = metrics.bilinear_resize_torch(torch.from_numpy(x), *out_hw)
    assert _rel_err(got, np.asarray(j_resize.bilinear_resize_torch(jnp.asarray(x), *out_hw))) <= 1e-4


@pytest.mark.parametrize("in_hw,out_hw", [((256, 256), (224, 224)), ((64, 64), (224, 224)),
                                          ((100, 100), (224, 224))])
def test_nearest_resize_matches_rick_tpu(in_hw, out_hw):
    x = np.random.default_rng(1).standard_normal((1, 3, *in_hw)).astype(np.float32)
    got = metrics.nearest_resize_torch(torch.from_numpy(x), *out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_resize.nearest_resize_torch(jnp.asarray(x), *out_hw)))


def test_resizes_pass_through_at_the_target_size():
    x = torch.randn(1, 3, 299, 299)
    assert metrics.bilinear_resize_torch(x, 299, 299) is x
    assert metrics.nearest_resize_torch(x, 299, 299) is x


# ---------------------------------------------------------------------------
# inception
# ---------------------------------------------------------------------------


def test_inception_init_np_is_rick_tpus_draw():
    got, want = metrics.inception_init_np(3), j_inception_init_np(3)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_randomize_bn_is_the_oracle_tests_draw():
    from tests.test_metrics_oracle import _randomize_bn

    params = metrics.inception_init_np(1)
    got, want = metrics.randomize_bn(params, seed=7), _randomize_bn(params, seed=7)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert not np.array_equal(got["Mixed_5b.branch1x1.bn.running_var"], params["Mixed_5b.branch1x1.bn.running_var"])


def _jax_pool3_f64(params, x, **kw):
    with jax.enable_x64(True):
        p64 = {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in params.items()}
        return np.asarray(j_inception_pool3(p64, jnp.asarray(x, jnp.float64), **kw))


def test_inception_trunk_matches_rick_tpu_f64_no_resize(incp):
    """The whole trunk on 96x96 input, f64 on both sides: 1e-9."""
    x = np.random.default_rng(7).standard_normal((1, 3, 96, 96))
    got = port_inception(incp, dtype=torch.float64).pool3(torch.from_numpy(x), resize_input=False,
                                                          normalize_input=False)
    want = _jax_pool3_f64(incp, x, resize_input=False, normalize_input=False)
    assert got.shape == (1, 2048) and _rel_err(got, want) <= 1e-9


def test_inception_fid_wrapper_matches_rick_tpu_f64(incp):
    """Resize 64 -> 299, the ImageNet remap and the trunk, f64: 1e-9."""
    x = np.random.default_rng(17).random((1, 3, 64, 64)) * 2 - 1
    got = port_inception(incp, dtype=torch.float64).pool3(torch.from_numpy(x))
    assert _rel_err(got, _jax_pool3_f64(incp, x)) <= 1e-9


def test_inception_cut_trunk_matches_rick_tpu_f32(incp):
    """stop_at="Mixed_6a", resize_to=75 (the evaluator tests' trunk), f32:
    1e-4 of max|ref| (convolutions summed in another order)."""
    x = (np.random.default_rng(19).random((2, 3, 16, 16)) * 2 - 1).astype(np.float32)
    kw = dict(stop_at="Mixed_6a", resize_to=75)
    got = port_inception(incp).pool3(torch.from_numpy(x), **kw)
    want = np.asarray(j_inception_pool3({k: jnp.asarray(v) for k, v in incp.items()}, jnp.asarray(x), **kw))
    assert got.shape == (2, 768) and _rel_err(got, want) <= 1e-4


def test_inception_channels_last_equals_nchw(incp):
    """channels_last (JAX's NHWC trunk) against NCHW, f32: 1e-5."""
    x = torch.from_numpy((np.random.default_rng(23).random((2, 3, 48, 48)) * 2 - 1).astype(np.float32))
    kw = dict(stop_at="Mixed_6a", resize_to=75)
    got = port_inception(incp, channels_last=True).pool3(x, **kw)
    assert _rel_err(got, port_inception(incp).pool3(x, **kw)) <= 1e-5


def test_inception_logits_match_rick_tpu_f64(incp):
    from rick_tpu.metrics.inception import inception_logits

    x = np.random.default_rng(29).random((1, 3, 75, 75)) * 2 - 1
    got = port_inception(incp, dtype=torch.float64).logits(torch.from_numpy(x), resize_input=False)
    with jax.enable_x64(True):
        p64 = {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in incp.items()}
        want = np.asarray(inception_logits(p64, jnp.asarray(x), resize_input=False))
    assert got.shape == (1, 1000) and _rel_err(got, want) <= 1e-9


def test_inception_loads_a_torchvision_state_dict(tmp_path, incp, monkeypatch):
    """A .pth with torchvision's extra keys (AuxLogits, num_batches_tracked),
    under "state_dict", loads through RICK_INCEPTION_WEIGHTS."""
    sd = {k: torch.from_numpy(v) for k, v in incp.items()}
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "inception_v3.pth"
    torch.save({"state_dict": sd}, path)
    monkeypatch.setenv("RICK_INCEPTION_WEIGHTS", str(path))
    loaded = metrics.default_inception_params()
    assert set(loaded) == set(incp)
    assert all(torch.equal(loaded[k], sd[k]) for k in incp)
    model = metrics.inception_from_params(loaded, device="cpu")
    assert torch.equal(model.state_dict()["Mixed_7c.branch_pool.bn.running_var"], sd["Mixed_7c.branch_pool.bn.running_var"])
    monkeypatch.delenv("RICK_INCEPTION_WEIGHTS")
    seeded = metrics.inception_init_np(0)
    assert all(np.array_equal(v, seeded[k]) for k, v in metrics.default_inception_params().items())


def test_inception_weights_that_are_missing_raise(tmp_path, monkeypatch):
    """A RICK_INCEPTION_WEIGHTS that names no file raises: the seeded init
    is taken only when the variable is unset."""
    monkeypatch.setenv("RICK_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        metrics.default_inception_params()


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------


def _stats(seed, shift, n=64, d=256):
    a = np.random.default_rng(seed).standard_normal((n, d)) + shift
    return a.mean(axis=0), np.cov(a, rowvar=False)


@pytest.mark.parametrize("n,jax_tol,scipy_tol", [(64, 1e-4, 1e-3), (512, 1e-5, 1e-5)])
def test_frechet_device_matches_rick_tpu_and_scipy(n, jax_tol, scipy_tol):
    """Seeded activations (d 256): the port's f32 device path against
    rick_tpu's `_frechet_device` (both f32) and against scipy in f64, as a
    fraction of the distance.  At n 64 both covariances are singular: the
    f32 path takes square roots of ~190 rounding-level eigenvalues (and
    clips the negative ones), which moves the trace by ~4e-4 of the distance
    in rick_tpu's device path as here (1e-3 against scipy), and by another
    ~5e-5 between two eigensolvers (1e-4 against rick_tpu).  At n 512
    (full rank): 1e-5 for both."""
    (m1, s1), (m2, s2) = _stats(0, 0.0, n), _stats(1, 0.3, n)
    got = fid.frechet_distance_device(*(torch.from_numpy(a) for a in (m1, s1, m2, s2)))
    want_dev = float(j_fid._frechet_device(*(jnp.asarray(a, jnp.float32) for a in (m1, s1, m2, s2))))
    want_scipy = j_fid.calculate_frechet_distance(m1, s1, m2, s2)
    assert abs(got - want_dev) <= jax_tol * abs(want_dev)
    assert abs(got - want_scipy) <= scipy_tol * abs(want_scipy)


def test_scipy_frechet_is_rick_tpus_exactly():
    (m1, s1), (m2, s2) = _stats(2, 0.0), _stats(3, 0.1)
    assert fid.calculate_frechet_distance(m1, s1, m2, s2) == j_fid.calculate_frechet_distance(m1, s1, m2, s2)


def test_uint8_activations_equal_f32_activations(incp):
    """uint8 pixels dequantized on the device give the f32 path's input
    exactly, hence the same activations."""
    u8 = np.random.default_rng(31).integers(0, 256, (4, 3, 16, 16), dtype=np.uint8)
    model = port_inception(incp)
    kw = dict(stop_at="Mixed_5b", resize_to=75)
    got = fid.get_activations(u8, 2, model, **kw)
    want = fid.get_activations(u8.astype(np.float32) / 127.5 - 1.0, 2, model, **kw)
    assert got.dtype == np.float64 and got.shape == (4, 256)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(fid.get_activations(torch.from_numpy(u8), 2, model, **kw), got)


def test_fid_given_images_truncates_to_whole_batches(incp):
    """5 and 3 images at batch 2 use the first 4 and 2; the distance is the
    device path on their statistics, and matches rick_tpu's on the same
    weights and images (f32, 1e-3 of the distance: d 2048 from 4 and 2
    samples, so most eigenvalues are rounding noise)."""
    rng = np.random.default_rng(37)
    a = (rng.random((5, 3, 16, 16)) * 2 - 1).astype(np.float32)
    b = (rng.random((3, 3, 16, 16)) * 2 - 1).astype(np.float32)
    model = port_inception(incp)
    got = fid.calculate_fid_given_images(a, b, model, batch_size=2)
    ma, sa = fid.activation_statistics(a[:4], 2, model)
    mb, sb = fid.activation_statistics(b[:2], 2, model)
    assert got == fid.frechet_distance_device(*(torch.from_numpy(x) for x in (ma, sa, mb, sb)))
    want = j_fid.calculate_fid_given_images(a, b, batch_size=2, params={k: jnp.asarray(v) for k, v in incp.items()})
    assert abs(got - want) <= 1e-3 * abs(want)
