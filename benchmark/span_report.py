"""What the program's spans and counters (`rick_tpu_torch/utils/trace.py`)
show of one cell, on the card:

    python3 -m benchmark.span_report --workload <cell> --seed <n> [--seconds S]

After the cell's set-up it runs the cell's window for `--seconds`
untraced, then one unit (a block of iterations, or an evaluation) inside
`trace.recording()` with no profiler, whose counters give the host time of
the kernel wrappers and of the loader's index upload and whose length is the
recorder's cost when on; then the cell's traced unit three times, at the
same iterations: with the program's spans kept out of the profiler, with
them in, and out again.  It prints one JSON line: the times per unit, the
counters, the per-layer metrics of the cell, how the traced unit's records
and launches pair (`program_spans`), the share of its device time that
program spans cover, each program span's device time and top device
records, the idle gaps by span, and the kernel records of the three traced
units with their launching calls (the spans launch nothing, so the calls
are the same, and the records differ only by those the profiler lost), and
the pairing by order held against the profiler's correlation ids, which
`benchmark/trace.py` does not keep.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import timeit
from types import SimpleNamespace

from benchmark import harness, program_spans, spec
from benchmark import trace as btrace

# a window this short runs one unit: the cells start a unit while under it
ONE_UNIT_S = 1e-3


def _window(ctx, prog, seconds: float):
    """The cell's window and its ms per unit (an evaluation cell counts its
    evaluations from the first window on)."""
    before = len(getattr(prog, "evals", ()))
    win = ctx.runner.window(ctx, prog, seconds)
    return win, 1e3 * win.seconds / (win.units - before)


def _traced(ctx, prog, spans_on: bool):
    """The cell's traced unit after one untraced unit; the program's spans
    in the profiler's trace or kept out of it."""
    from rick_tpu_torch.utils import trace

    on = trace._profiler_enabled
    if not spans_on:
        trace._profiler_enabled = lambda: False
    win = ctx.runner.window(SimpleNamespace(**{**vars(ctx), "trace": True}), prog, ONE_UNIT_S)
    trace._profiler_enabled = on
    return win


def off_cost_ns() -> dict:
    """Host ns of one `span` and one `count` call while nothing records."""
    from rick_tpu_torch.utils import trace

    n = 200_000
    return {f: 1e9 * min(timeit.repeat(lambda: fn("x").__enter__(), number=n, repeat=5)) / n
            for f, fn in (("span", trace.span), ("count", trace.count))}


def _kept_events(fn):
    """`fn()` with the raw events of its traced unit kept: `trace.captured`
    reads its records from them and drops them."""
    kept = []
    real = btrace.json
    btrace.json = SimpleNamespace(load=lambda f: kept.append(json.load(f)) or kept[-1])
    try:
        win = fn()
    finally:
        btrace.json = real
    return win, kept[-1]["traceEvents"] if kept else []


def _against_correlation(cap, events) -> dict:
    """The pairing by order against the profiler's own correlation ids: the
    launches without a record (their places in the launch order), the
    device streams, and, aligned at the start and at the end, the share of
    device time put down to another span than its launch's."""
    xs = [ev for ev in events if ev.get("ph") == "X" and "correlation" in ev.get("args", {})]
    launch_at = {ev["args"]["correlation"]: int(round(float(ev["ts"]) * 1e3)) for ev in xs
                 if ev.get("cat") in ("cuda_runtime", "cuda_driver") and ev["name"].startswith(program_spans.LAUNCHES)}
    device = {(ev["name"], int(round(float(ev["ts"]) * 1e3))): ev["args"] for ev in xs
              if ev.get("cat") in btrace.DEVICE_ACTIVITY}
    records = sorted(cap.device, key=lambda x: x[1])
    truth = [launch_at.get(device.get((n, s), {}).get("correlation")) for n, s, _ in records]
    starts = program_spans.launches(cap)
    recorded = {a.get("correlation") for a in device.values()}
    order = sorted(launch_at.items(), key=lambda kv: kv[1])
    missing = [k for k, (c, _) in enumerate(order) if c not in recorded]
    spans = [x for x in cap.spans if x[0].startswith(program_spans.PROGRAM)]

    def names(times):
        idx = sorted((t, k) for k, t in enumerate(times) if t is not None)
        got = program_spans._innermost(spans, [t for t, _ in idx])
        out = [None] * len(times)
        for (_, k), name in zip(idx, got):
            out[k] = name
        return out

    want = names(truth)
    total = sum(e - s for _, s, e in records)
    n = min(len(records), len(starts))
    out = {"launches_without_record_at": missing[:20], "launches_without_record": len(missing),
           "records_without_launch": sum(t is None for t in truth),
           "streams": dict(collections.Counter(str(a.get("stream")) for a in device.values()))}
    for align, times in (("start", starts[:n] + [None] * (len(records) - n)),
                         ("end", [None] * (len(records) - n) + starts[len(starts) - n:])):
        got = names(times)
        out[f"misplaced_pct_{align}"] = 100.0 * sum(e - s for (_, s, e), a, b in zip(records, got, want)
                                                   if a != b) / total
    return out


def _kernel_records(wins) -> dict:
    """The kernel records and launching calls of the traced units (spans
    out, in, out again), and the kernels by which their records differ."""
    off, on, off2 = (collections.Counter(n for n, _, _ in w.capture.kernels) for w in wins)
    return {"spans_off": sum(off.values()), "spans_on": sum(on.values()), "spans_off_again": sum(off2.values()),
            "launch_calls": [len(program_spans.launches(w.capture)) for w in wins],
            "off_minus_on": dict(off - on), "on_minus_off": dict(on - off),
            "off_again_minus_off": dict(off2 - off), "off_minus_off_again": dict(off - off2)}


def report(workload: str, seed: int, seconds: float, device: str = "cuda", bench=None, **kw) -> dict:
    from rick_tpu_torch.utils import trace

    ctx = harness.make_ctx(workload, seed, False, device, bench, **kw)
    prog = ctx.runner.setup(ctx)
    out = {"workload": workload, "seed": seed, "off_cost_ns": off_cost_ns()}
    win, out["window_ms_per_unit"] = _window(ctx, prog, seconds)
    with trace.recording():
        _, out["spans_on_ms_per_unit"] = _window(ctx, prog, ONE_UNIT_S)
    got = trace.counters()
    out["counters"] = {name: {"calls": calls, "ns_per_call": ns / calls} for name, (calls, ns) in got.items()}
    wrappers = [v for name, v in got.items() if name.startswith("ops.")]
    if wrappers:
        out["wrapper_host_us"] = sum(ns for _, ns in wrappers) / sum(calls for calls, _ in wrappers) / 1e3
    if "data.index_upload" in got:
        calls, ns = got["data.index_upload"]
        out["index_upload_ms"] = ns / calls / 1e6
    off = _traced(ctx, prog, False)
    on, events = _kept_events(lambda: _traced(ctx, prog, True))
    traced = [off, on, _traced(ctx, prog, False)]
    cap = traced[1].capture
    if cap is not None:
        out["against_correlation"] = _against_correlation(cap, events)
        win.capture, win.traced_work, win.launches = cap, traced[1].traced_work, traced[1].launches
        win.spans["fisher"] = traced[1].spans.get("fisher", [])  # the round timed alone
        record = harness.Record(win, ctx.flops)
        out["metrics"] = {m["name"]: spec.metric_reader(m["name"], ctx.root).read(record)
                          for m in spec.per_layer_for(ctx.bench, workload)}
        out["kernel_records"] = _kernel_records(traced)
        out["pairing"] = {"device_records": len(cap.device), "launch_calls": len(program_spans.launches(cap))}
        out["coverage_pct"] = program_spans.coverage(cap)
        out["busy_s"] = cap.busy_s()
        by = program_spans.device_ns(cap) or {}
        out["spans"] = {str(name): {"count": program_spans.span_count(cap, name) if name else 0, "device_s": ns / 1e9,
                                    "top": program_spans.top_records(cap, name) if name else []}
                        for name, ns in sorted(by.items(), key=lambda kv: -kv[1])}
        out["idle_gaps"] = cap.idle_gaps()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    print(json.dumps(report(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
