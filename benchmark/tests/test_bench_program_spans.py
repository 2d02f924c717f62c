"""The program's spans in a hand-made capture: each device record put down
to the innermost program span at its launch, the seven readers that use
them, and the share of device time the spans cover."""

import pytest

from benchmark import harness, program_spans, spec
from benchmark.trace import Capture

MS = 1_000_000  # ns
US = 1_000


def _launch(t_ms, name="cudaLaunchKernel"):
    return (name, int(t_ms * MS), int(t_ms * MS) + 5 * US)


def _train_capture():
    """One iteration (D, R1, G, path) inside the harness's span, a Fisher
    round before it, and a kernel the harness launched after it.  The device
    runs behind the host: D's second kernel runs while the host is in R1,
    and R1's backward kernel was launched (by the autograd engine's thread)
    while the phase's thread waited inside `train.r1`."""
    spans = [("fisher_round", 0, 20 * MS), ("fisher.round", 1 * MS, 19 * MS),
             ("run_iteration", 20 * MS, 100 * MS), ("train.iteration", 21 * MS, 99 * MS),
             ("train.d", 22 * MS, 40 * MS), ("train.r1", 40 * MS, 60 * MS), ("train.g", 60 * MS, 80 * MS),
             ("train.path", 80 * MS, 98 * MS)]
    # (launch ms, record name, device start ms, device ms)
    work = [(2, "fim_kernel", 3, 10.0),
            (25, "d_fprop", 26, 4.0), (30, "d_dgrad", 41, 6.0),  # D's second kernel runs during R1's host time
            (45, "r1_bwd", 50, 8.0),  # launched from the autograd thread inside train.r1
            (65, "g_fprop", 66, 5.0), (70, "Memcpy HtoD (Pageable -> Device)", 72, 1.0),
            (85, "path_dgrad", 86, 3.0),
            (99.5, "harness_fetch", 100, 2.0)]  # inside run_iteration, outside every program span
    host = [("aten::conv2d", 24 * MS, 31 * MS)]
    device = []
    for launch_ms, name, start_ms, dur_ms in work:
        host.append(_launch(launch_ms, "cudaMemcpyAsync" if name.startswith("Memcpy") else "cudaLaunchKernel"))
        device.append((name, int(start_ms * MS), int((start_ms + dur_ms) * MS)))
    # a `cuLaunchKernel` the runtime made inside its own launch counts once
    host.append(("cuLaunchKernel", 25 * MS + 1 * US, 25 * MS + 3 * US))
    return Capture(window_s=0.2, t0_ns=0, t1_ns=200 * MS, device=device, host=host, spans=spans,
                   kernels=[d for d in device if not d[0].startswith("Memcpy")])


def _record(cap, traced_work, spans=None):
    win = harness.Window(seconds=2.0, units=10, spans=spans or {}, capture=cap, traced_work=traced_work)
    return harness.Record(win, {})


def _read(name, record):
    return spec.metric_reader(name).read(record)


def test_records_go_to_the_span_of_their_launch():
    cap = _train_capture()
    got = program_spans.attributed(cap)
    assert [(span, name) for span, name, _ in got] == [
        ("fisher.round", "fim_kernel"), ("train.d", "d_fprop"), ("train.d", "d_dgrad"), ("train.r1", "r1_bwd"),
        ("train.g", "g_fprop"), ("train.g", "Memcpy HtoD (Pageable -> Device)"), ("train.path", "path_dgrad"),
        (None, "harness_fetch")]
    assert program_spans.top_records(cap, "train.d") == [["d_dgrad", 0.006], ["d_fprop", 0.004]]
    # 39 ms in all, of which the harness's fetch (2 ms) is outside every program span
    assert program_spans.coverage(cap) == pytest.approx(100 * 37 / 39)


def test_training_readers():
    rec = _record(_train_capture(), {"iteration": 1, "fisher_round": 1}, {"fisher": [0.025]})
    assert _read("d_device_ms.train", rec) == pytest.approx(10.0)
    assert _read("r1_device_ms.train", rec) == pytest.approx(8.0)
    assert _read("g_device_ms.train", rec) == pytest.approx(6.0)
    assert _read("path_device_ms.train", rec) == pytest.approx(3.0)
    # 10 ms of device time in the round against the 25 ms round timed alone
    assert _read("fisher_busy_pct.train", rec) == pytest.approx(40.0)


def test_phase_ms_is_per_span():
    cap = _train_capture()
    cap.spans.append(("train.d", 150 * MS, 160 * MS))
    cap.host.append(_launch(151))
    cap.device.append(("d_fprop", 152 * MS, 154 * MS))
    assert _read("d_device_ms.train", _record(cap, {"iteration": 2})) == pytest.approx((10.0 + 2.0) / 2)


def test_evaluation_readers():
    spans = [("eval.score", 0, 100 * MS)]
    host, device = [], []
    for c in range(2):
        t0 = 1 + 40 * c
        spans += [("eval.generate", t0 * MS, (t0 + 20) * MS), ("eval.inception", (t0 + 20) * MS, (t0 + 35) * MS)]
        host += [_launch(t0 + 1), _launch(t0 + 21)]
        device += [("modconv", (t0 + 2) * MS, (t0 + 9) * MS), ("inception_conv", (t0 + 22) * MS, (t0 + 26) * MS)]
    host.append(_launch(90))
    device.append(("frechet", 91 * MS, 92 * MS))  # eval.score alone
    cap = Capture(window_s=0.1, t0_ns=0, t1_ns=100 * MS, device=device, host=host, spans=spans, kernels=device)
    rec = _record(cap, {"evaluation": 1})
    assert _read("gen_device_ms.eval", rec) == pytest.approx(14.0)
    assert _read("inception_device_ms.eval", rec) == pytest.approx(8.0)
    assert program_spans.coverage(cap) == pytest.approx(100.0)


def test_pairs_go_by_order_not_by_the_clocks():
    cap = _train_capture()
    # the device's clock reads D's first kernel as starting before its call did
    cap.device[1] = ("d_fprop", 25 * MS - 2 * US, 29 * MS)
    assert [span for span, _, _ in program_spans.attributed(cap)][:3] == ["fisher.round", "train.d", "train.d"]


def test_a_record_the_profiler_lost_at_the_start_leaves_the_rest_paired():
    cap = _train_capture()
    del cap.device[0]  # the Fisher round's kernel, the unit's first
    cap.host += [_launch(150 + k) for k in range(999)]
    cap.device += [("late", (150 + k) * MS + 10 * US, (150 + k) * MS + 20 * US) for k in range(999)]
    got = program_spans.attributed(cap)
    assert [span for span, _, _ in got][:7] == ["train.d", "train.d", "train.r1", "train.g", "train.g", "train.path",
                                               None]
    assert program_spans.span_count(cap, "fisher.round") == 1
    assert _read("fisher_busy_pct.train", _record(cap, {"iteration": 1}, {"fisher": [0.025]})) == 0.0


def test_records_and_launches_that_do_not_pair_give_nothing():
    cap = _train_capture()
    cap.device.append(("no_launch", 150 * MS, 151 * MS))  # one record in 9 without a call: over `UNPAIRED`
    assert program_spans.attributed(cap) is None
    assert _read("d_device_ms.train", _record(cap, {"iteration": 1})) is None
    cap = _train_capture()
    cap.host.append(_launch(150))  # a call in 9 without a record
    assert program_spans.attributed(cap) is None


def test_a_program_without_spans_gives_nothing():
    cap = _train_capture()
    cap.spans[:] = [x for x in cap.spans if not x[0].startswith(program_spans.PROGRAM)]
    rec = _record(cap, {"iteration": 1, "evaluation": 1}, {"fisher": [0.025]})
    for name in ("d_device_ms.train", "r1_device_ms.train", "g_device_ms.train", "path_device_ms.train",
                 "fisher_busy_pct.train", "gen_device_ms.eval", "inception_device_ms.eval"):
        assert _read(name, rec) is None, name
    assert program_spans.coverage(cap) is None
