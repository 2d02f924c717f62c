"""The port's data-parallel training phases on 2 gloo ranks (CPU, 8px)
against one process: each phase (D, R1, G, path length; ADA off and on,
with the adaptive p firing on the global count) and `run_iteration` at
i = 0 and 16, from the same state and the same global draws, each rank on
its rows.  Held as `tests/test_torch_train.py` holds the port to rick_tpu
(PHASE_TOL, ITER_TOL: the two sum the batch in another order), and the two
ranks' states bitwise equal.  The path batch of 1 on 2 ranks runs whole on
each (the replicated phase)."""

import numpy as np
import pytest
import torch

from rick_tpu_torch.train import TrainConfig, sample_draws
from tests.torch_dist_workers import (
    ADA,
    BASE,
    ITER_TOL,
    PG,
    PHASE_TOL,
    REPLICATED,
    SIZE,
    phases_worker,
    run_ranks,
    start_tree,
)
from tests.torch_port_helpers import one_torch_thread, rand  # noqa: F401


def _draws(tcfg_kw, seed):
    tcfg = TrainConfig(**tcfg_kw)
    gen = torch.Generator().manual_seed(seed)
    p = torch.tensor(0.3)
    return {"d": sample_draws(gen, PG, tcfg, 2, ada_p=p, ada_batch=4),
            "g": sample_draws(gen, PG, tcfg, 2, ada_p=p, ada_batch=2),
            "path": sample_draws(gen, PG, tcfg, max(1, 2 // tcfg.path_batch_shrink), path=True)}


CASES = [  # (id, TrainConfig kwargs, phase, i, tolerance)
    ("d", BASE, "d", 4, PHASE_TOL),
    ("r1", BASE, "r1", 4, PHASE_TOL),
    ("g", BASE, "g", 4, PHASE_TOL),
    ("path", BASE, "path", 4, PHASE_TOL),
    ("path_replicated", REPLICATED, "path", 4, PHASE_TOL),
    ("d_ada", ADA, "d", 4, PHASE_TOL),
    ("g_ada", ADA, "g", 4, PHASE_TOL),
    ("iteration_0", BASE, "iteration", 0, ITER_TOL),
    ("iteration_16_replicated_path", REPLICATED, "iteration", 16, ITER_TOL),
    ("iteration_0_ada", ADA, "iteration", 0, ITER_TOL),
]


@pytest.fixture(scope="module")
def runs():
    tree = start_tree()
    cases = [(kw, phase, rand((2, 3, SIZE, SIZE), 30 + k), _draws(kw, 40 + k), i, tol)
             for k, (_, kw, phase, i, tol) in enumerate(CASES)]
    return run_ranks(phases_worker, 2, tree, cases)


@pytest.mark.parametrize("k", range(len(CASES)), ids=[c[0] for c in CASES])
def test_two_ranks_match_one_process(runs, k):
    """Rank 0's state against one process's (compare_states at the case's
    tolerance), the metrics within its loss tolerance, and both ranks'
    metrics and states bitwise equal."""
    tol = CASES[k][-1]
    a, b = runs[0][k], runs[1][k]
    assert a["error"] is None, a["error"]
    assert a["metrics"] == b["metrics"] and a["digest"] == b["digest"]
    got, want = a["metrics"], a["ref_metrics"]
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    np.testing.assert_allclose(got, want, rtol=tol["loss"], atol=tol["loss"])


def test_the_ada_update_fired_on_the_global_count(runs):
    """From 254 pooled predictions the D phase's 2 (one per rank) make 256:
    p steps by exactly ada_step * 256 and the pool resets."""
    k = [c[0] for c in CASES].index("d_ada")
    for rank_runs in runs:
        small = rank_runs[k]["small"]
        assert small["ada_stats"].tolist() == [0.0, 0.0]
        assert abs(abs(float(small["ada_p"]) - 0.3) - TrainConfig(**ADA).ada_step * 256) < 1e-7
