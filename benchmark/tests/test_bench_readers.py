"""Each per-layer reader on a record made by hand, and nothing where there
is nothing to read."""

import pytest

from benchmark import harness, roofline, spec
from benchmark.trace import Capture

MS = 1_000_000  # ns


def _record(capture=None, work=None, launches=(), spans=None, flops=None):
    win = harness.Window(seconds=2.0, units=10, spans=spans or {}, work=work or {}, capture=capture,
                         traced_work=work or {}, launches=list(launches))
    return harness.Record(win, flops or {})


def _read(name, record):
    return spec.metric_reader(name).read(record)


def test_spans():
    rec = _record(spans={"data_wait": [0.001, 0.003], "fisher": [0.5]})
    assert _read("data_wait_ms.train", rec) == pytest.approx(2.0)
    assert _read("fisher_ms.train", rec) == pytest.approx(500.0)


def test_device_trace_readers():
    k1 = ("void (anonymous namespace)::fba_rows<float4>(...)", 0, 2 * MS)
    k4 = ("void convt_blur_act_kernel<3, 32>(...)", 5 * MS, 9 * MS)
    other = ("sm80_xmma_fprop_implicit_gemm", 10 * MS, 20 * MS)
    cap = Capture(window_s=0.04, t0_ns=0, t1_ns=40 * MS, device=[k1, k4, other, ("Memcpy HtoD", 30 * MS, 31 * MS)],
                  kernels=[k1, k4, other])
    args_k1 = (0, 0, 0, 1 << 20, 128, 1 << 13, 0.2, 1.41, 0)
    args_k4 = (0, 0, 0, 0, 0, 0, 4, 256, 128, 16, 16, 1, 0.0, 0.0, 0.0, 0.0, 1, 0.2, 1.41, 3, 0)
    rec = _record(cap, {"iteration": 2, "d": 2, "g": 2, "evaluation": 1},
                  [("rick_fused_bias_act", args_k1), ("rick_convt_blur_act_stage", args_k4)],
                  flops={"d": 1e12, "g": 1e12, "r1": 5e12, "path": 5e12, "fisher_round": 1e13, "evaluation": 2e12})
    # busy 17 ms per traced unit, against the window's 200 ms per unit; the traced window's 40 ms is not used
    assert _read("idle_pct.train", rec) == pytest.approx(100 * (1 - 17 / 2 / 200))
    assert _read("idle_pct.eval", rec) == pytest.approx(100 * (1 - 17 / 200))
    assert _read("launches_per_iter.train", rec) == 1.5
    assert _read("mfu.train", rec) == pytest.approx(100 * 4e12 / (2.0 * 495e12))
    assert _read("mfu.eval", rec) == pytest.approx(100 * 2e12 / (2.0 * 495e12))
    assert _read("kernel_roofline.train", rec) == pytest.approx(
        100 * roofline.launch_bound("rick_fused_bias_act", args_k1) / 2.0)
    assert _read("kernel_roofline.eval", rec) == pytest.approx(
        100 * roofline.launch_bound("rick_convt_blur_act_stage", args_k4) / 4.0)


def test_eval_roofline_reads_k4_and_k6():
    k4 = ("void convt_blur_act_kernel<3, 32>(...)", 0, 4 * MS)
    k6 = ("void (anonymous namespace)::modconv_act_kernel<(anonymous namespace)::Geom<8, 16> >(...)", 5 * MS, 8 * MS)
    k3 = ("void (anonymous namespace)::epi_rows<float>(...)", 9 * MS, 10 * MS)
    cap = Capture(window_s=0.01, t0_ns=0, t1_ns=10 * MS, device=[k4, k6, k3], kernels=[k4, k6, k3])
    args_k4 = (0, 0, 0, 0, 0, 0, 4, 256, 128, 16, 16, 1, 0.0, 0.0, 0.0, 0.0, 1, 0.2, 1.41, 3, 0)
    args_k6 = (0,) * 8 + (100, 512, 512, 64, 64, 1, 0.2, 1.41, 0)
    args_k3 = (0, 0, 0, 0, 0, 0, 4, 128, 256 * 256, 1, 0.2, 1.41, 0)
    k4_k6 = [("rick_convt_blur_act_stage", args_k4), ("rick_modconv_act", args_k6)]
    rec = _record(cap, {"evaluation": 1}, k4_k6 + [("rick_modconv_epilogue", args_k3)])
    assert _read("kernel_roofline.eval", rec) == pytest.approx(
        100 * (roofline.launch_bound(*k4_k6[0]) + roofline.launch_bound(*k4_k6[1])) / 7.0)
    # a K6 launch whose record the trace lost: no share
    rec = _record(cap, {"evaluation": 1}, k4_k6 + [k4_k6[1]])
    assert _read("kernel_roofline.eval", rec) is None


def test_nothing_to_read_gives_nothing():
    empty = _record()
    for m in spec.load_benchmark()["per_layer"]:
        assert _read(m["name"], empty) is None, m["name"]
    cap = Capture(window_s=0.01, t0_ns=0, t1_ns=10 * MS, device=[("k", 0, MS)], kernels=[("k", 0, MS)])
    # a launch recorded that the trace lost: the two do not pair, so no share
    rec = _record(cap, {"iteration": 1}, [("rick_fused_bias_act", (0, 0, 0, 10, 1, 10, 0.2, 1.4, 0))])
    assert _read("kernel_roofline.train", rec) is None


def test_idle_gaps_name_the_host():
    cap = Capture(window_s=0.01, t0_ns=0, t1_ns=10 * MS, device=[("k", 0, MS), ("k", 6 * MS, 7 * MS)],
                  host=[("aten::conv", 2 * MS, 5 * MS), ("cudaLaunchKernel", 3 * MS, 4 * MS)],
                  spans=[("run_iteration", 0, 9 * MS)])
    gaps = cap.idle_gaps()
    assert gaps[0] == ["run_iteration/cudaLaunchKernel", 0.005] and gaps[1][1] == pytest.approx(0.003)
    assert cap.busy_s() == pytest.approx(0.002)
