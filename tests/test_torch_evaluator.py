"""The port's in-loop evaluator (`rick_tpu_torch.metrics.Evaluator`) against
`rick_tpu.metrics.evaluator` at 16px.

G's weights go from `rick_tpu`'s init through the port's converter; Inception
is the seeded init with randomized batch-norm statistics, cut after
Mixed_6a at a 75px input (768-d), on both sides, so that the file stays
cheap.  jax and torch draw different numbers from one seed, so the
comparisons hand both sides the same latents, with G's constant noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.metrics.evaluator import _stats_from_acts as j_stats_from_acts
from rick_tpu.metrics.fid import _frechet_device as j_frechet_device
from rick_tpu.metrics.inception import inception_init_np, inception_pool3
from rick_tpu.nn import GeneratorConfig, generator_init
from rick_tpu.nn.generator import generator_apply
from rick_tpu_torch.metrics import Evaluator, kid_subsets
from rick_tpu_torch.metrics.evaluator import _stats_from_acts
from tests.torch_port_helpers import one_torch_thread, perturb_zeros, port_generator, randomize_bn  # noqa: F401

TRUNK = dict(inception_stop_at="Mixed_6a", inception_resize_to=75)
J_TRUNK = dict(stop_at="Mixed_6a", resize_to=75)


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


@pytest.fixture(scope="module")
def setup():
    gcfg = GeneratorConfig(size=16)
    gp = perturb_zeros(generator_init(jax.random.key(0), gcfg), 100)
    incp = randomize_bn(inception_init_np(0), seed=3)
    real = np.random.default_rng(0).integers(0, 256, (8, 3, 16, 16), dtype=np.uint8)
    ev = Evaluator(gcfg, fid_real_samples=real, inception_nsamples=8, batch_size=8, gen_batch=4,
                   inception_params=incp, seed=1, device="cpu", **TRUNK)
    return dict(gcfg=gcfg, gp=gp, g=port_generator(gcfg, gp), incp=incp, real=real, ev=ev,
                j_incp={k: jnp.asarray(v) for k, v in incp.items()})


def _kw(s, **over):
    """Evaluator kwargs of the fixture's, with the real acts cached."""
    kw = dict(inception_nsamples=8, batch_size=8, gen_batch=4, inception_params=s["incp"], seed=1,
              device="cpu", real_acts=s["ev"]._real_acts, **TRUNK)
    kw.update(over)
    return kw


def _jax_side(s, z):
    """rick_tpu's fake stats of the latents z (constant noise) and real stats."""
    imgs = generator_apply(s["gcfg"], s["gp"], [jnp.asarray(z)], rng=None)[0]
    acts = inception_pool3(s["j_incp"], imgs, **J_TRUNK)
    real = jnp.asarray(s["real"].astype(np.float32) / 127.5 - 1.0)
    real_acts = inception_pool3(s["j_incp"], real, **J_TRUNK)
    return acts, j_stats_from_acts(acts), real_acts, j_stats_from_acts(real_acts)


def test_stats_and_fid_from_latents_match_rick_tpu(setup):
    """mu and cov of 8 fixed latents through G and the cut Inception, and the
    real set's activations, against rick_tpu: 1e-4 of max|ref| (G and the
    Inception convolutions summed in another order, f32).  The FID from
    both: 1e-4 of the distance (n 8 against d 768, so both covariances are
    singular and the trace takes ~760 rounding-level eigenvalues)."""
    s = setup
    z = np.random.default_rng(5).standard_normal((8, 512)).astype(np.float32)
    acts_j, (mu_j, cov_j), real_acts_j, (rmu_j, rcov_j) = _jax_side(s, z)
    acts = s["ev"].activations(s["g"], torch.from_numpy(z))
    mu, cov = _stats_from_acts(acts)
    assert acts.shape == (8, 768)
    assert _rel_err(acts, acts_j) <= 1e-4
    assert _rel_err(mu, mu_j) <= 1e-4 and _rel_err(cov, cov_j) <= 1e-4
    assert _rel_err(s["ev"]._real_acts, real_acts_j) <= 1e-4
    want = float(j_frechet_device(rmu_j, rcov_j, mu_j, cov_j))
    assert abs(s["ev"].fid(mu, cov) - want) <= 1e-4 * abs(want)


@pytest.mark.parametrize("n,asked,want", [(5000, 100, 100), (10, 4, 2), (12, 100, 12), (7, 4, 1)])
def test_gen_batch_is_brought_down_to_a_divisor(setup, n, asked, want):
    ev = Evaluator(setup["gcfg"], fid_real_samples=setup["real"], **_kw(setup, inception_nsamples=n, gen_batch=asked))
    assert (ev.gen_batch, ev.n_chunks) == (want, n // want)


def test_real_acts_pass_through_skips_extraction(setup):
    s = setup
    ev = Evaluator(s["gcfg"], fid_real_samples=s["real"][:1], **_kw(s))
    np.testing.assert_array_equal(ev._real_acts, s["ev"]._real_acts)
    assert torch.equal(ev._real_mu, s["ev"]._real_mu) and torch.equal(ev._real_cov, s["ev"]._real_cov)


def test_uint8_reals_equal_f32_reals(setup):
    """uint8 pixels dequantized on the device are the f32 path's inputs
    exactly, hence the same activations."""
    s = setup
    real_f32 = s["real"].astype(np.float32) / 127.5 - 1.0
    kw = _kw(s)
    del kw["real_acts"]
    ev = Evaluator(s["gcfg"], fid_real_samples=real_f32, **kw)
    np.testing.assert_array_equal(ev._real_acts, s["ev"]._real_acts)


def test_kid_subsets_match_a_numpy_mmd():
    rng = np.random.default_rng(7)
    real, fake = rng.standard_normal((20, 16)), rng.standard_normal((20, 16)) + 0.2
    ri, fi = (np.stack([rng.permutation(20)[:10] for _ in range(5)]) for _ in range(2))
    got = kid_subsets(*(torch.from_numpy(a) for a in (real.astype(np.float32), fake.astype(np.float32), ri, fi)))

    def k(a, b):
        return (a @ b.T / 16 + 1.0) ** 3

    want = []
    for gi, rj in zip(ri, fi):
        g, r = real[gi], fake[rj]
        kxx, kyy, kxy = k(g, g), k(r, r), k(g, r)
        want.append((kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / 90 - 2 * kxy.sum() / 100)
    # f32 against f64 sums of 100 terms of size ~1: 1e-5 of max|ref|
    assert _rel_err(got, np.array(want)) <= 1e-5


def test_compute_inception_score_fid_and_kid_are_finite_and_seeded(setup):
    s = setup
    a = Evaluator(s["gcfg"], fid_real_samples=s["real"], **_kw(s)).compute_inception_score(s["g"], kid=True)
    b = Evaluator(s["gcfg"], fid_real_samples=s["real"], **_kw(s)).compute_inception_score(s["g"], kid=True)
    assert set(a) == {"fid", "kid"} and np.isfinite(a["fid"]) and a["fid"] >= 0 and np.isfinite(a["kid"])
    assert a == b  # the same seed draws the same latents and noise


def test_host_sqrtm_path_agrees_with_the_device_path(setup, monkeypatch):
    """RICK_FID_HOST_SQRTM=1: f64 real stats and scipy; against the f32
    device path on the same fake stats, 1e-3 of the distance (singular
    covariances, as above)."""
    s = setup
    z = np.random.default_rng(9).standard_normal((8, 512)).astype(np.float32)
    mu, cov = _stats_from_acts(s["ev"].activations(s["g"], torch.from_numpy(z)))
    device = s["ev"].fid(mu, cov)
    monkeypatch.setenv("RICK_FID_HOST_SQRTM", "1")
    host = s["ev"].fid(mu, cov)
    assert abs(host - device) <= 1e-3 * abs(host)


def test_fast_gen_on_the_cpu_gives_the_plain_paths_stats(setup):
    """fast_gen=True on the CPU takes K4's plain version: the same stats as
    the training chain within f32 reassociation, 1e-5 of max|ref|."""
    s = setup
    z = torch.from_numpy(np.random.default_rng(11).standard_normal((8, 512)).astype(np.float32))
    assert s["ev"]._fast is False  # fast_gen=None on the CPU
    fast = Evaluator(s["gcfg"], fid_real_samples=s["real"], **_kw(s, fast_gen=True))
    for got, want in zip(_stats_from_acts(fast.activations(s["g"], z)), _stats_from_acts(s["ev"].activations(s["g"], z))):
        assert _rel_err(got, want) <= 1e-5


def test_generate_returns_host_images_in_store_chunks(setup):
    imgs = setup["ev"].generate(setup["g"], n=30)
    assert imgs.shape == (30, 3, 16, 16) and imgs.device.type == "cpu" and torch.isfinite(imgs).all()


def test_unported_options_raise(setup):
    """Nothing raises any longer: the sharded evaluation takes a process
    `group` (rick_tpu's `mesh=`; 2 ranks in tests/test_torch_dist_eval.py),
    and without one, or over one rank, the evaluation is the single
    process's; P&R and intra-LPIPS are ported (tests/test_torch_scores.py),
    and so is a bf16 generation (tests/test_torch_bf16.py)."""
    s = setup
    assert Evaluator(s["gcfg"], fid_real_samples=s["real"], **_kw(s, group=None)).group is None
    with pytest.raises(TypeError):
        Evaluator(s["gcfg"], fid_real_samples=s["real"], **_kw(s, mesh=object()))  # the keyword is `group`
    ev = Evaluator(s["gcfg"], fid_real_samples=s["real"], **_kw(s, gen_dtype=torch.bfloat16))
    assert ev.gen_dtype == torch.bfloat16
