"""The port's precision/recall, KID, Inception Score and LeNet features, and
the Evaluator's precision/recall and intra-LPIPS, against `rick_tpu.metrics`.

VGG16 is drawn with numpy at `rick_tpu`'s scales and handed to both sides (in
the Evaluator through `default_vgg16_params`, which the test replaces);
Inception is the seeded init with randomized batch-norm statistics; G is
`rick_tpu`'s 16px init through the port's converter.  jax and torch draw
different numbers from one seed, so generated images come from explicit
latents with G's constant noise, or, for intra-LPIPS, from the port's draws
handed to `rick_tpu`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.metrics import inception_score as j_is
from rick_tpu.metrics import intra_lpips as j_intra
from rick_tpu.metrics import kid as j_kid
from rick_tpu.metrics import lenet as j_lenet
from rick_tpu.metrics import precision_recall as j_pr
from rick_tpu.metrics.inception import inception_init_np
from rick_tpu.nn import GeneratorConfig, generator_init
from rick_tpu.nn.generator import generator_apply
from rick_tpu_torch.metrics import (
    IPR,
    Evaluator,
    inception_score,
    lenet_features,
    load_lenet_params,
    polynomial_mmd_averages,
    prepare_cluster_centers,
)
from rick_tpu_torch.metrics import intra_lpips as port_intra
from rick_tpu_torch.metrics import precision_recall as pr
from rick_tpu_torch.metrics.vgg import PARAM_SHAPES
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    perturb_zeros,
    port_generator,
    port_inception,
    randomize_bn,
)

TRUNK = dict(inception_stop_at="Mixed_6a", inception_resize_to=75)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def vgg():
    """VGG16 weights at rick_tpu's scales (He-normal convs, N(0, 0.01^2) fc
    layers), with small non-zero biases, drawn with numpy: cheaper than
    rick_tpu's `vgg16_init`; and the same as jax arrays."""
    rng = np.random.default_rng(61)
    params = {}
    for k, shape in PARAM_SHAPES.items():
        scale = 0.01 if k.endswith(".bias") or k.startswith("classifier") else np.sqrt(2.0 / (shape[1] * 9))
        params[k] = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return dict(np=params, jax={k: jnp.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def features():
    """f64 'fc2 features': a real set and a shifted fake set that overlap in part."""
    rng = np.random.default_rng(62)
    real = rng.standard_normal((40, 256)) * 3.0
    fake = rng.standard_normal((36, 256)) * 3.0 + np.linspace(0, 1.5, 256)
    return real, fake


def test_distances_and_radii_match_rick_tpu(features):
    """The numpy plain versions and the f64 device versions (on CPU tensors)
    against rick_tpu: 1e-12 of max|ref|."""
    real, fake = features
    want = j_pr.compute_pairwise_distances(real, fake)
    np.testing.assert_array_equal(pr.compute_pairwise_distances(real, fake), want)
    assert _rel_err(pr.pairwise_distances_device(torch.from_numpy(real), torch.from_numpy(fake)), want) <= 1e-12
    d_rr = j_pr.compute_pairwise_distances(real)
    want_radii = j_pr.distances2radii(d_rr, k=3)
    np.testing.assert_array_equal(pr.distances2radii(d_rr, k=3), want_radii)
    got_radii = pr.radii_device(pr.pairwise_distances_device(torch.from_numpy(real)), k=3)
    assert _rel_err(got_radii, want_radii) <= 1e-12


def test_metric_and_realism_match_rick_tpu(features):
    real, fake = features
    j_ref = j_pr.Manifold(real, j_pr.distances2radii(j_pr.compute_pairwise_distances(real), k=3))
    want = j_pr.compute_metric(j_ref, fake)
    assert 0.0 < want < 1.0
    assert pr.compute_metric(pr.Manifold(*j_ref), fake) == want
    ref = pr.manifold_device(torch.from_numpy(real), k=3)
    assert pr.compute_metric_device(ref, torch.from_numpy(fake)) == want
    for f in fake[:5]:
        assert abs(pr.realism(pr.Manifold(*j_ref), f) - j_pr.realism(j_ref, f)) <= 1e-12 * j_pr.realism(j_ref, f)


def test_ipr_end_to_end_equals_rick_tpu(vgg):
    """VGG16 fc2 at 224 of 8 real and 8 fake 16px images, manifolds, P&R:
    the features within 1e-4 of max|ref|, precision and recall equal, the
    realism of one image within 1e-5.  The reals are two tight groups of 4,
    the fakes 4 near the first group and 4 near neither."""
    rng = np.random.default_rng(63)
    base = rng.uniform(-1, 1, (3, 3, 16, 16))

    def group(b, n):
        return np.clip(base[b] + rng.normal(0, 0.05, (n, 3, 16, 16)), -1, 1).astype(np.float32)

    real, fake = np.concatenate([group(0, 4), group(1, 4)]), np.concatenate([group(0, 4), group(2, 4)])
    j_ipr = j_pr.IPR(8, k=3, params=vgg["jax"])
    j_ipr.compute_manifold_ref(real)
    ipr = IPR(8, k=3, params=vgg["np"], device="cpu")
    ipr.compute_manifold_ref(real)
    assert _rel_err(ipr.manifold_ref.features, j_ipr.manifold_ref.features) <= 1e-4
    want = j_ipr.precision_and_recall(fake)
    assert tuple(ipr.precision_and_recall(fake)) == tuple(want)
    assert 0.0 < want.precision < 1.0
    assert abs(ipr.realism(fake[:1]) - j_ipr.realism(fake[:1])) <= 1e-5 * j_ipr.realism(fake[:1])


def test_polynomial_mmd_averages_match_rick_tpu():
    """Seeded subsets, and the global np.random when seed is None (seeded
    alike before each side): 1e-12 of the values."""
    rng = np.random.default_rng(64)
    g, r = rng.standard_normal((30, 64)), rng.standard_normal((25, 64)) + 0.1
    for kw in (dict(seed=3), dict(seed=None)):
        np.random.seed(5)
        want = j_kid.polynomial_mmd_averages(g, r, n_subsets=7, subset_size=20, **kw)
        np.random.seed(5)
        got = polynomial_mmd_averages(g, r, n_subsets=7, subset_size=20, **kw)
        for a, b in zip(got, want):
            assert _rel_err(a, b) <= 1e-12


@pytest.mark.parametrize("src,resize", [(75, False), (16, True)])
def test_inception_score_matches_rick_tpu(src, resize):
    """8 images, batch 4, 2 splits, through the whole trunk and fc: 1e-5 of
    the mean, and the spread within 1e-5 of the mean."""
    params = randomize_bn(inception_init_np(0), seed=3)
    imgs = np.random.default_rng(65).uniform(-1, 1, (8, 3, src, src)).astype(np.float32)
    want = j_is.inception_score(imgs, batch_size=4, splits=2, resize=resize,
                                params={k: jnp.asarray(v) for k, v in params.items()})
    got = inception_score(imgs, port_inception(params), batch_size=4, splits=2, resize=resize)
    assert abs(got[0] - want[0]) <= 1e-5 * want[0] and abs(got[1] - want[1]) <= 1e-5 * want[0]
    with pytest.raises(ValueError):
        inception_score(imgs, port_inception(params), batch_size=8)


def test_lenet_features_match_rick_tpu(tmp_path):
    """Seeded LeNet5 params (the repo ships no lenet.pth) through a
    `torch.save`d file read by both packages: 1e-5 of max|ref|."""
    rng = np.random.default_rng(66)
    shapes = {"convnet.c1": (6, 1, 5, 5), "convnet.c3": (16, 6, 5, 5), "convnet.c5": (120, 16, 5, 5),
              "fc.f6": (84, 120 * 2 * 2)}
    sd = {}
    for name, shape in shapes.items():
        sd[f"{name}.weight"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) / np.sqrt(np.prod(shape[1:])))
        sd[f"{name}.bias"] = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32) * 0.1)
    torch.save(sd, tmp_path / "lenet.pth")
    x = rng.uniform(-1, 1, (3, 1, 32, 32)).astype(np.float32)
    want = np.asarray(j_lenet.lenet_features(j_lenet.load_lenet_params(str(tmp_path / "lenet.pth")), jnp.asarray(x)))
    got = lenet_features(load_lenet_params(str(tmp_path / "lenet.pth")), torch.from_numpy(x))
    assert got.shape == (3, 84) and _rel_err(got, want) <= 1e-5


@pytest.fixture(scope="module")
def gen16():
    gcfg = GeneratorConfig(size=16)
    gp = perturb_zeros(generator_init(jax.random.key(0), gcfg), 100)
    incp = randomize_bn(inception_init_np(0), seed=3)
    # the real set: G's images of other latents, quantized, and noise
    z = np.random.default_rng(67).standard_normal((4, 512)).astype(np.float32)
    imgs = np.asarray(generator_apply(gcfg, gp, [jnp.asarray(z)], rng=None)[0])
    noise = np.random.default_rng(68).uniform(-1, 1, (2, 3, 16, 16))
    real = np.clip(np.rint((np.concatenate([imgs, noise]) + 1) * 127.5), 0, 255).astype(np.uint8)
    return dict(gcfg=gcfg, gp=gp, g=port_generator(gcfg, gp), incp=incp, real=real)


def _evaluator(s, **over):
    kw = dict(fid_real_samples=s["real"], inception_nsamples=6, batch_size=6, gen_batch=3, inception_params=s["incp"],
              seed=1, device="cpu", **TRUNK)
    kw.update(over)
    return Evaluator(s["gcfg"], **kw)


def test_evaluator_precision_recall_matches_rick_tpus_ipr(gen16, vgg, monkeypatch):
    """The real manifold of the uint8 set and VGG features of 6 fixed latents
    (constant noise) through the port's Evaluator against rick_tpu's IPR on
    the same images: P&R equal; then one compute_inception_score(pr=True)
    of fresh draws gives P&R in [0, 1] beside the FID."""
    s = gen16
    monkeypatch.setattr(pr, "default_vgg16_params", lambda: vgg["np"])
    ev = _evaluator(s, compute_pr=True)
    z = np.random.default_rng(69).standard_normal((6, 512)).astype(np.float32)
    feats = ev.vgg_features(s["g"], torch.from_numpy(z))
    ev.ipr.compute_manifold_ref(ev.real)
    got = pr.precision_and_recall_device(ev.ipr.manifold_ref, pr.manifold_device(feats))

    imgs = np.asarray(generator_apply(s["gcfg"], s["gp"], [jnp.asarray(z)], rng=None)[0])
    j_ipr = j_pr.IPR(6, k=3, params=vgg["jax"])
    j_ipr.compute_manifold_ref(s["real"].astype(np.float32) / 127.5 - 1.0)
    j_feats = j_ipr.extract_features(imgs)
    assert _rel_err(feats, j_feats) <= 1e-4
    j_fake = j_pr.Manifold(j_feats, j_pr.distances2radii(j_pr.compute_pairwise_distances(j_feats), k=3))
    assert tuple(got) == (j_pr.compute_metric(j_ipr.manifold_ref, j_feats),
                          j_pr.compute_metric(j_fake, j_ipr.manifold_ref.features))

    ref = ev.ipr.manifold_ref
    score = ev.compute_inception_score(s["g"], pr=True)
    assert set(score) == {"fid", "precision", "recall"} and ev.ipr.manifold_ref is ref
    assert 0.0 <= score["precision"] <= 1.0 and 0.0 <= score["recall"] <= 1.0 and np.isfinite(score["fid"])
    with pytest.raises(ValueError, match="compute_pr"):
        _evaluator(s, real_acts=ev._real_acts).compute_inception_score(s["g"], pr=True)


def test_evaluator_intra_lpips_matches_rick_tpus(gen16, vgg, monkeypatch, tmp_path):
    """compute_intra_lpips at 16px (2 prepared centers, 8 samples, clusters
    of at most 3) against rick_tpu's IntraLPIPS on the samples that the same
    seed draws: 1e-5 of the value."""
    s = gen16
    monkeypatch.setattr(port_intra, "default_vgg16_params", lambda: vgg["np"])
    monkeypatch.delenv("RICK_LPIPS_WEIGHTS", raising=False)
    prepare_cluster_centers(np.random.default_rng(70).uniform(-1, 1, (2, 3, 16, 16)), str(tmp_path))
    got = _evaluator(s).compute_intra_lpips(s["g"], str(tmp_path), n_samples=8, cluster_size=3, k=2, size=16, seed=0)
    samples = _evaluator(s)._generate(s["g"], 8).numpy()
    j_il = j_intra.IntraLPIPS(j_intra.load_cluster_centers(str(tmp_path), k=2, size=16), cluster_size=3, size=16,
                              vgg_params=vgg["jax"])
    want = j_il.compute(samples, rng=np.random.default_rng(0))
    assert np.isfinite(want) and abs(got - want) <= 1e-5 * abs(want)
