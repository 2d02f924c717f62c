"""What a `--trace 1` run records: host spans around the calls into each
layer, the device's activity from `torch.profiler` over one unit of the
window, and the shapes of the port's kernel launches.

The profiler pattern is the port's `tools/profile_gen.py::profile_phase`:
synchronize, profile CPU and CUDA activity, synchronize, and read the
kernel records by name.  Here the records are read raw, from the trace's
events, so that a traced unit of some hundred thousand events is reduced in
seconds: the device's busy time is the union of its intervals, its idle gaps are
labelled by the host span and the innermost host operation running at
their midpoint.

The launch shapes come from the port's kernels' C entry points, which take
the shape as arguments: `LaunchLog` wraps the loaded library while a traced
unit runs and keeps each call's name and arguments.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.roofline import KERNELS

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


class _Recording:
    def __init__(self, lib, calls: list):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in KERNELS:
            return fn

        def call(*args):
            self._calls.append((name, args))
            return fn(*args)

        return call


class LaunchLog:
    """The port's kernel launches made inside `recording()`: (entry point, arguments)."""

    def __init__(self):
        self.calls: List[tuple] = []

    @contextlib.contextmanager
    def recording(self):
        from rick_tpu_torch.ops import _build

        real = _build.lib
        proxy = _Recording(real(), self.calls)
        _build.lib = lambda: proxy
        try:
            yield self
        finally:
            _build.lib = real


@dataclass
class Capture:
    """One traced unit: its host window and the device and host events in it."""

    window_s: float = 0.0
    t0_ns: int = 0
    t1_ns: int = 0
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)  # the benchmark's own record_function spans
    kernels: List[Interval] = field(default_factory=list)  # the device's kernel records alone

    def busy_s(self) -> float:
        total, end = 0, self.t0_ns
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, end, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                total += e - s
                end = e
        return total / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by_name: Dict[str, int] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest stretches of the window with nothing on the device,
        each named by what the host was doing at its midpoint."""
        gaps, end = [], self.t0_ns
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, min(s, self.t1_ns)))
            end = max(end, e)
        if self.t1_ns > end:
            gaps.append((end, self.t1_ns))
        gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda x: x[1])
        starts = [s for _, s, _ in host]
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            out.append([f"{_covering(self.spans, mid) or 'harness'}/{_innermost(host, starts, mid) or 'idle'}",
                        (e - s) / 1e9])
        return out


def _covering(spans: List[Interval], t: int) -> Optional[str]:
    inside = [x for x in spans if x[1] <= t < x[2]]
    return min(inside, key=lambda x: x[2] - x[1])[0] if inside else None


def _innermost(host: List[Interval], starts: List[int], t: int, look_back: int = 20000) -> Optional[str]:
    i = bisect.bisect_right(starts, t)
    best = None
    for name, s, e in host[max(0, i - look_back): i]:
        if e > t and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler."""
    from torch.profiler import record_function

    return record_function(name)


no_span = contextlib.nullcontext

UNIT = "traced_unit"
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITY = ("cpu_op", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def captured(capture: Capture):
    """Profile the block into `capture`, the device synchronized at both
    ends; the window is the block's own annotation, on the events' clock.
    The events are read from the profiler's Chrome trace, whose categories
    are the same across PyTorch's versions, written under TMPDIR and
    deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(UNIT):
            yield capture
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        kind = ev.get("cat", "")
        start = int(round(float(ev["ts"]) * 1e3))
        item = (ev["name"], start, start + int(round(float(ev.get("dur", 0)) * 1e3)))
        if kind == "user_annotation":
            if item[0] == UNIT:
                capture.t0_ns, capture.t1_ns = item[1], item[2]
            else:
                capture.spans.append(item)
        elif kind in DEVICE_ACTIVITY:
            capture.device.append(item)
            if kind == "kernel":
                capture.kernels.append(item)
        elif kind in HOST_ACTIVITY:
            capture.host.append(item)
    capture.window_s = (capture.t1_ns - capture.t0_ns) / 1e9
