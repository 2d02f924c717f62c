"""`span_report` on the CPU at a small size: the recorded unit's counters
(the kernel wrappers' CPU paths, the loader's index upload); the traced
parts need the card, but the check of the pairing against the profiler's
correlation ids runs on a hand-made unit."""

import pytest
import torch

import bench_tiny
from benchmark import span_report
from benchmark.trace import Capture


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("bench")
    return root, bench_tiny.make(root)


def test_training_cell_counters(tiny):
    root, bench = tiny
    got = span_report.report(bench_tiny.TRAIN, 2**31 + 99, 0.2, device="cpu", bench=bench, root=root)
    assert got["window_ms_per_unit"] > 0 and got["spans_on_ms_per_unit"] > 0
    # one block of 5 iterations, one Fisher round in it reading one batch per image
    uploads = got["counters"]["data.index_upload"]["calls"]
    assert uploads == 5 + bench_tiny.spec.traffic("recipe-train")["num_fisher_img"]
    assert got["counters"]["ops.fused_bias_act"]["calls"] > 0
    assert got["wrapper_host_us"] > 0 and got["index_upload_ms"] > 0
    assert "metrics" not in got  # no traced unit on the CPU
    assert set(got["off_cost_ns"]) == {"span", "count"}


def test_evaluation_cell_counts_no_upload(tiny):
    root, bench = tiny
    got = span_report.report(bench_tiny.FID, 2**31 + 99, 0.2, device="cpu", bench=bench, root=root)
    assert "data.index_upload" not in got["counters"] and "index_upload_ms" not in got
    assert got["counters"]["ops.modconv_epilogue"]["calls"] > 0


def test_pairing_against_correlation_ids():
    """The profiler lost the unit's first record: aligned at the end, no
    device time goes to another span; aligned at the start, G's first
    kernel goes to D."""
    ms = 1_000_000
    spans = [("train.d", 0, 10 * ms), ("train.g", 10 * ms, 20 * ms)]
    host, device, events = [], [], []
    for k, (launch, start) in enumerate([(1, 2), (5, 6), (11, 12), (15, 16)]):
        host.append(("cudaLaunchKernel", launch * ms, launch * ms + 5000))
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch * 1000, "dur": 5,
                       "args": {"correlation": k}})
        if k:
            device.append((f"k{k}", start * ms, start * ms + 1000))
            events.append({"ph": "X", "cat": "kernel", "name": f"k{k}", "ts": start * 1000, "dur": 1,
                           "args": {"correlation": k, "stream": 7}})
    cap = Capture(device=device, host=host, spans=spans, kernels=device)
    got = span_report._against_correlation(cap, events)
    assert got["launches_without_record_at"] == [0] and got["records_without_launch"] == 0
    assert got["misplaced_pct_end"] == 0.0 and got["misplaced_pct_start"] == pytest.approx(100 / 3)
