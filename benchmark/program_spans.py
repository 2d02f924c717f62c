"""The program's own spans in a traced unit: each device record (kernel,
memcpy, memset) put down to the innermost program span whose interval
covers the host call that launched it.

The program (`rick_tpu_torch/utils/trace.py`) enters its spans through
`torch.profiler.record_function` while a profiler runs, so they are among the
capture's annotations (`Capture.spans`), on the clock of the device's
records; the benchmark's own spans have names without a dot.  The capture
keeps each host CUDA API call by name and interval, not the
profiler's correlation ids, so a record is paired with its launch by order:
the records by start and the calls by start are paired from the last back.
The profiler loses the first few records of a unit (it starts collecting the
device's activity a moment after the host's), so where the counts differ,
the calls or records left over at the start stay unpaired; where they differ
by more than `UNPAIRED` of the records, nothing is paired. The pairs are not
exact record by record (some kernels run on side streams, and the two
clocks differ by microseconds), but a record and its true launch fall in the
same span: held against the correlation ids (`span_report`), the pairs put
no device time in another span than its launch's (PERF.md §3).

A launch's span is decided by time alone, whatever the thread: the autograd
engine launches a backward's kernels from its own thread while the phase's
thread waits inside its span.  A version of the program without these spans
gives nothing here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# the program's span names begin with one of these (`rick_tpu_torch/utils/trace.py`)
PROGRAM = ("train.", "fisher.", "data.", "eval.")
# host calls that put one record on the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset",
            "cuMemcpy", "cuMemset")
# the largest difference of the counts of records and launches, as a share of the records, that is paired
UNPAIRED = 0.001

Attributed = List[Tuple[Optional[str], str, int]]  # (innermost program span or None, record, device ns)


def launches(cap) -> List[int]:
    """Start times of the host calls that put a record on the device, in
    order; a call inside another (a `cuLaunchKernel` the runtime made) counts
    once."""
    calls = sorted((s, e) for name, s, e in cap.host if name.startswith(LAUNCHES))
    out, end = [], None
    for s, e in calls:
        if end is not None and s < end:
            continue
        out.append(s)
        end = e
    return out


def _innermost(spans: List[tuple], times: List[int]) -> List[Optional[str]]:
    """The innermost of `spans` covering each of `times` (ascending)."""
    spans = sorted(spans, key=lambda x: x[1])
    out, active, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            active.append(spans[j])
            j += 1
        active = [x for x in active if x[2] > t]
        out.append(max(active, key=lambda x: x[1])[0] if active else None)
    return out


def attributed(cap) -> Optional[Attributed]:
    """Each device record, in order, with its innermost program span at its
    launch (None outside every program span, or unpaired); None where the
    capture holds no program span or its records and launches do not
    pair."""
    if cap is None or not cap.device:
        return None
    spans = [x for x in cap.spans if x[0].startswith(PROGRAM)]
    if not spans:
        return None
    records, paired = pairs(cap)
    if paired is None:
        return None
    unpaired = len(records) - len(paired)
    names = [None] * unpaired + _innermost(spans, paired)
    return [(span, name, e - s) for span, (name, s, e) in zip(names, records)]


def pairs(cap) -> Tuple[list, Optional[List[int]]]:
    """(the device records by start, the launch times of the last records,
    as many as both have, in order), the times None where the counts differ
    by more than `UNPAIRED` of the records."""
    starts = launches(cap)
    records = sorted(cap.device, key=lambda x: x[1])
    n = min(len(records), len(starts))
    if abs(len(records) - len(starts)) > UNPAIRED * len(records):
        return records, None
    return records, starts[len(starts) - n:]


def device_ns(cap) -> Optional[Dict[Optional[str], int]]:
    """Device ns by innermost program span (None: outside every one)."""
    got = attributed(cap)
    if got is None:
        return None
    out: Dict[Optional[str], int] = {}
    for span, _, ns in got:
        out[span] = out.get(span, 0) + ns
    return out


def coverage(cap) -> Optional[float]:
    """The share of the traced unit's device time launched inside some
    program span, in %."""
    by = device_ns(cap)
    if not by:
        return None
    total = sum(by.values())
    return 100.0 * (total - by.get(None, 0)) / total if total else None


def span_count(cap, name: str) -> int:
    return sum(1 for x in cap.spans if x[0] == name)


def ms_per_span(record, name: str) -> Optional[float]:
    """Device ms put down to the spans named `name`, per such span."""
    by = device_ns(record.capture)
    n = span_count(record.capture, name) if by is not None else 0
    return by.get(name, 0) / n / 1e6 if n else None


def ms_per_unit(record, name: str, unit: str) -> Optional[float]:
    """Device ms put down to the spans named `name`, per traced `unit`."""
    by = device_ns(record.capture)
    done = record.window.traced_work.get(unit)
    if by is None or not done or not span_count(record.capture, name):
        return None
    return by.get(name, 0) / done / 1e6


def top_records(cap, name: str, top: int = 3) -> List[list]:
    """The device records put down to the spans named `name` with the most
    device time, by record name: [name, s]."""
    by: Dict[str, int] = {}
    for span, record, ns in attributed(cap) or ():
        if span == name:
            by[record] = by.get(record, 0) + ns
    return [[k, ns / 1e9] for k, ns in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
