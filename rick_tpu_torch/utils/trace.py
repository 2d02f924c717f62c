"""The program's own spans and counters.

`span(name)` marks a stretch of host work with
`torch.profiler.record_function` while a profiler runs or `recording()` is
on.  Under a running profiler the span lands in the profiler's own trace, on
the clock of the device's kernel records, so that a kernel (by its launch
time) or an idle gap of the device can be put down to the span it fell in.
Otherwise `span` returns one shared object that does nothing: no clock read,
no allocation, no `record_function`.

`count(name)` adds one call and the host nanoseconds from entry to exit
(`time.perf_counter_ns`) to counter `name`, only inside `recording()`, which
resets the counters at entry; `counters()` reads them.  The counted calls
run on the caller's thread or, for a backward, on the autograd engine's
while the caller waits in it, so no two update one counter at once.

Nothing but code turns either on: no environment variable, no flag.  This
module imports nothing of the package, so that `ops/` can import it.

Every name given to `span` or `count` in the package is listed in PERF.md
(§3), beside the metric that reads it.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_clock = time.perf_counter_ns


class _Off:
    """What `span` and `count` return while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Recorder:
    def __init__(self):
        self.on = False
        self.counts: Dict[str, list] = {}  # name -> [calls, host ns]


_REC = _Recorder()


class _Timed:
    """One counted call: its host nanoseconds from entry to exit."""

    __slots__ = ("_row", "_t0")

    def __init__(self, row: list):
        self._row = row

    def __enter__(self):
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self._row[1] += _clock() - self._t0
        self._row[0] += 1
        return False


def span(name: str):
    """`record_function(name)` while a profiler runs or `recording()` is on,
    else the shared do-nothing object."""
    if _REC.on or _profiler_enabled():
        return record_function(name)
    return OFF


def count(name: str):
    """A block counted under `name` inside `recording()`, else the shared
    do-nothing object."""
    if not _REC.on:
        return OFF
    row = _REC.counts.get(name)
    if row is None:
        row = _REC.counts[name] = [0, 0]
    return _Timed(row)


class recording:
    """Spans and counters on for the block; the counters start from zero and
    keep their values after it."""

    def __enter__(self):
        _REC.counts.clear()
        _REC.on = True
        return self

    def __exit__(self, *exc):
        _REC.on = False
        return False


def counters() -> Dict[str, Tuple[int, int]]:
    """{name: (calls, host ns)} of the last or current `recording()`."""
    return {name: (calls, ns) for name, (calls, ns) in _REC.counts.items()}
