"""The harness end to end on the CPU at a small size: the result line's
schema, a sound run that comes out correct, and each fault of
`benchmark/faults.py` planted in the program coming out not correct under
the real cells' limits.  The look for a card is skipped (the device is
"cpu"); every other part of a run is driven."""

import math

import pytest
import torch

import bench_tiny
from benchmark import control, faults, harness


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("bench")
    return root, bench_tiny.make(root)


@pytest.mark.parametrize("workload,e2e", [(bench_tiny.TRAIN, "train_iter_ms"), (bench_tiny.FID, "fid5k_s")])
def test_sound_run_and_result_line(tiny, workload, e2e):
    root, bench = tiny
    ctx = harness.make_ctx(workload, 2**31 + 12345, False, "cpu", bench, root)
    res = harness.run(ctx, 0.5)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", e2e}
    assert all(m["value"] > 0 and m["unit"] for m in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(ctx.limits)
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


@pytest.mark.parametrize("workload,fault", [(bench_tiny.TRAIN, f) for f in faults.TRAIN]
                         + [(bench_tiny.FID, f) for f in faults.EVAL])
def test_fault_is_not_correct(tiny, workload, fault):
    root, bench = tiny
    got = control.readings(workload, 7, False, 0.2, [fault], control=False, device="cpu", bench=bench, root=root)
    limits = harness.make_ctx(workload, 7, False, "cpu", bench, root).limits
    checks = got[f"fault:{fault}"]
    assert not harness.judge(checks, limits), (fault, checks)


def test_judge():
    assert harness.judge({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert not harness.judge({"a": 1.5}, {"a": 1.0})
    assert not harness.judge({"a": math.inf}, {"a": 1.0})
    assert not harness.judge({"a": math.nan}, {"a": 1.0})
