"""The port's train CLI on 2 gloo ranks (CPU, 16px) against one process:
the README recipe's kind of run cut to iterations 0-2 (a Fisher round with
its 2 images sharded, an evaluation at 0 and 2 sharded over the ranks,
sample grids, a checkpoint), on the staged stream, which hands the ranks
the one process's global batches."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from rick_tpu_torch.ckpt import load_state
from rick_tpu_torch.cli import train
from tests.torch_dist_workers import cli_worker, run_ranks
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

SIZE = 16
FLAGS = ["--size", str(SIZE), "--batch", "2", "--num_fisher_img", "2", "--allow_random_fisher_noise",
         "--warmup_iter", "1", "--fisher_freq", "2", "--eval_in_training", "--eval_in_training_freq", "2",
         "--n_sample_test", "4", "--n_sample_store", "4", "--store_samples", "--samples_freq", "2",
         "--store_checkpoints", "--checkpoints_freq", "2", "--iter", "-8"]  # iterations 0-2 (to --iter + 10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    chip_smoke.write_synthetic_store(str(root), SIZE, 10, 4)
    flags = chip_smoke.cli_flags(str(root)) + FLAGS + ["--exp"]  # the last --exp is the run's
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        one = train.main(flags + ["one"], device="cpu")
    two = run_ranks(cli_worker, 2, flags + ["two"])
    return root / "out", (one, printed.getvalue()), two


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree, np.float64)}


def _files(path: Path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*") if p.is_file())


def test_two_ranks_run_what_one_process_runs(runs):
    _, (one, _), two = runs
    for summary, _ in two:
        for k in ("start_iter", "iterations", "fisher_rounds", "evaluations"):
            assert summary[k] == one[k], k
    assert (one["iterations"], one["fisher_rounds"], one["evaluations"]) == (3, 1, 2)
    assert two[0][0]["best_fid"] == two[1][0]["best_fid"]  # every rank sees the same FID


def test_files_are_written_once_by_rank_0(runs):
    """The same files as one process writes, and rank 1 prints nothing."""
    out, _, two = runs
    assert _files(out / "two") == _files(out / "one")
    assert two[1][1] == ""


def test_the_log_lines_match(runs):
    """The same lines at the same steps; the losses of iteration 0 (from
    one state, the same global draws and batch) within 1e-5, relatively,
    as a phase against one process (tests/test_torch_dist_train.py).  The
    FIDs are of the same samples (4 samples are one chunk of 4 in one
    process and a chunk of 2 on each rank, cut from the same block of
    draws), through a g_ema that differs by the order of the gradient sums:
    within 1e-4, relatively, the 2-rank Evaluator test's FID tolerance."""
    out, (_, printed), two = runs
    def head(text):
        return [line.split(":")[0] for line in text.splitlines() if not line.startswith("done in")]

    assert head(two[0][1]) == head(printed)
    recs = {name: [json.loads(x) for x in (out / name / "stats.jsonl").read_text().splitlines()]
            for name in ("one", "two")}
    assert [sorted(r) for r in recs["two"]] == [sorted(r) for r in recs["one"]]
    for a, b in zip(recs["two"], recs["one"]):
        for k, v in b.items():
            if k == "fid":
                np.testing.assert_allclose(a[k], v, rtol=1e-4, atol=0, err_msg=k)
            elif k not in ("step", "time", "t"):
                np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
            assert np.isfinite(a[k])


def test_the_checkpoints_agree(runs):
    """000002.state.npz of the two runs, per array in norm, as chip_smoke.py
    holds the card against the CPU (three iterations from the same state,
    the gradients summed in another order; Adam's first steps are lr *
    sign(g) where v is 0): each array within 1e-3 of the other's norm, and
    the one-element ones (G's noise weights, D's final bias, the path and
    ADA scalars) as one vector within chip_smoke.SCALAR_TOL (a noise
    weight's gradient is a sum over its layer that cancels to a small part
    of its terms)."""
    out, _, _ = runs
    (a, ma), (b, mb) = (load_state(str(out / n / "checkpoints" / "000002.state.npz")) for n in ("two", "one"))
    assert ma["step"] == mb["step"] == 2
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    rel = lambda x, y: float(np.linalg.norm(x - y) / np.linalg.norm(y))  # noqa: E731
    worst = max((rel(fa[k], fb[k]), k) for k in fb if fb[k].size > 1 and np.any(fb[k]))
    assert worst[0] <= 1e-3, worst
    ones = [k for k in fb if fb[k].size == 1]
    assert rel(np.concatenate([fa[k].reshape(1) for k in ones]), np.concatenate([fb[k].reshape(1) for k in ones])) \
        <= chip_smoke.SCALAR_TOL
