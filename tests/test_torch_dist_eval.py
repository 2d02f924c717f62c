"""The port's sharded Fisher accumulation and sharded Evaluator on 2 gloo
ranks (CPU, 8px) against one process.

Fisher: 4 images, 2 per rank, the per-rank sums of squared gradients
all-reduced; with the registered noise and with fresh noise (every rank
draws every image's, so image i takes the same noise as in one process); 3
images do not divide and run whole on each rank.  The Evaluator: 8 samples
in chunks of 2, two chunks per rank, generated from per-chunk seeds, so the
two ranks generate the one process's samples; Inception cut at Mixed_6a at
75px (tests/test_torch_evaluator.py's cut).  On 4 ranks, 20 samples at
gen_batch 4: a per-rank chunk of 5 that is not the one process's chunk of
4, and the same samples all the same."""

import numpy as np
import pytest
import torch

from rick_tpu_torch.ckpt import train_state_to_jax
from rick_tpu_torch.metrics import inception_init_np, randomize_bn
from rick_tpu_torch.nn import Generator
from rick_tpu_torch.train import TrainConfig, init_train_state
from tests.torch_dist_workers import PD, PG, SIZE, eval_blocks_worker, eval_worker, fims_worker, run_ranks
from tests.torch_port_helpers import one_torch_thread, rand  # noqa: F401


FISHER_CASES = [(4, True), (4, False), (3, False)]


@pytest.fixture(scope="module")
def fims():
    state = init_train_state(PG, PD, TrainConfig(), rng=torch.Generator().manual_seed(0), device="cpu")
    cases = [(rand((n, 512), 5), rand((n, 3, SIZE, SIZE), 6), const) for n, const in FISHER_CASES]
    return run_ranks(fims_worker, 2, train_state_to_jax(state), cases)


@pytest.mark.parametrize("k", range(len(FISHER_CASES)), ids=["4_registered_noise", "4_fresh_noise", "3_fresh_noise"])
def test_sharded_fisher_sums_match_one_process(fims, k):
    """4 images: squared per-image gradients summed on each rank, then one
    all-reduce: every entry within 2e-6 of one process's, relatively (sums
    of non-negative terms in another order; a square taken after the reduce
    would be off by O(1)), zeros where it has zeros, and both ranks equal.
    3 images: each rank runs the whole round and takes rank 0's sums: one
    process's, bitwise."""
    outs = [rank_out[k] for rank_out in fims]
    assert outs[0]["digest"] == outs[1]["digest"]
    if FISHER_CASES[k][0] % 2:
        assert outs[0]["bitwise"]
    else:
        assert outs[0]["rel"] <= 2e-6 and outs[0]["zeros_kept"]


SETTINGS = [(8, 3), (12, 4), (8, 100), (7, 2)]
WANT = [(4, 1, True), (3, 2, True), (4, 1, True), (1, 7, False)]  # 3 and 5 tie around 4: the larger


@pytest.fixture(scope="module")
def eval_inputs():
    g = Generator(SIZE, rng=torch.Generator().manual_seed(7))
    return {k: v.numpy() for k, v in g.state_dict().items()}, randomize_bn(inception_init_np(0), seed=3)


@pytest.fixture(scope="module")
def evals(eval_inputs):
    g_sd, incp = eval_inputs
    real = np.random.default_rng(0).integers(0, 256, (4, 3, SIZE, SIZE), dtype=np.uint8)
    return run_ranks(eval_worker, 2, g_sd, real, incp, SETTINGS)


def test_sharded_evaluation_matches_one_process(evals):
    """mu and cov from all-reduced sums within 1e-5 of max|ref| of one
    process's two-pass f32 stats, the FID within 1e-4 of it (8 samples
    against 768 dimensions: singular covariances); KID and P&R, from the
    gathered activations and features of the same samples, equal; every
    rank returns the same scores."""
    a, b, one = evals[0]["sharded"], evals[1]["sharded"], evals[0]["one"]
    assert a["chunks"] == (2, 2, True) and one["chunks"] == (2, 4, False)
    assert a["score"] == b["score"] and a["again"] == b["again"]
    for k in ("mu", "cov"):
        assert np.abs(a[k] - one[k]).max() <= 1e-5 * np.abs(one[k]).max(), k
    assert abs(a["score"]["fid"] - one["score"]["fid"]) <= 1e-4 * abs(one["score"]["fid"])
    assert abs(a["again"] - one["again"]) <= 1e-4 * abs(one["again"]) and a["again"] != a["score"]["fid"]
    for k in ("kid", "precision", "recall"):
        assert a["score"][k] == one["score"][k], k


def test_chunk_size_is_the_nearest_divisor_of_the_per_rank_count(evals):
    assert [tuple(s) for s in evals[0]["settings"]] == WANT


def test_samples_that_do_not_divide_run_whole_on_each_rank(evals):
    assert evals[0]["odd_fid"] == evals[1]["odd_fid"] == evals[0]["odd_fid_one"]


def test_four_ranks_at_another_chunk_size_generate_one_process_samples(eval_inputs):
    """20 samples at gen_batch 4: one process runs 5 chunks of 4, each of 4
    ranks one chunk of 5 (the divisor of 5 nearest 4) that spans two of
    them.  The draws come in blocks of the one-process chunk, seeded by the
    block's index, so the 4 ranks' latents and per-layer noise, gathered,
    equal one process's bitwise, and mu and cov are within 1e-5 of max|ref|
    of its (the 2-rank test's tolerance)."""
    g_sd, incp = eval_inputs
    outs = run_ranks(eval_blocks_worker, 4, g_sd, incp, 20, 4)
    assert all(o["chunks"] == (5, 1, 4, True) for o in outs)
    assert outs[0]["one_chunks"] == (4, 5, 4, False)
    assert outs[0]["draws_equal"]
    assert max(outs[0]["stats_err"]) <= 1e-5
