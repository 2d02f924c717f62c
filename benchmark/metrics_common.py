"""Arithmetic the per-layer readers share (`metrics/*.py`)."""

from __future__ import annotations

from benchmark.roofline import KERNELS, PEAK_TF32_FLOP_PER_S, launch_bound


def model_share(record, units) -> float | None:
    """The model FLOPs of the window's completed work over the window times
    the peak, in %."""
    win = record.window
    if not win.seconds or not any(win.work.get(u) for u in units):
        return None
    flops = sum(win.work.get(u, 0) * record.flops[u] for u in units)
    return 100.0 * flops / (win.seconds * PEAK_TF32_FLOP_PER_S)


def roofline_share(record, entry_points) -> float | None:
    """Sum of the launches' bounds over the sum of the matching kernels'
    device time, in %; nothing where the launches recorded and the kernel
    records found do not pair one to one."""
    cap = record.capture
    if cap is None:
        return None
    launches = [(fn, args) for fn, args in record.window.launches if fn in entry_points]
    names = tuple(n for fn in entry_points for n in KERNELS[fn][1])
    records = [(s, e) for name, s, e in cap.kernels if any(n in name for n in names)]
    if not launches or len(launches) != len(records):
        return None
    bound_ms = sum(launch_bound(fn, args) for fn, args in launches)
    device_ms = sum(e - s for s, e in records) / 1e6
    return 100.0 * bound_ms / device_ms


def idle_share(record, unit: str) -> float | None:
    """The share of the untraced window in which the device idled: the
    traced unit's device busy time per `unit` over the window's time per
    `unit`, in %.  The traced unit's own length is not used: the profiler's
    host cost stretches it where the host sets the pace, and leaves the
    device's busy time as it is."""
    cap, win = record.capture, record.window
    done = record.window.traced_work.get(unit)
    if cap is None or not cap.device or not done or not win.units:
        return None
    return 100.0 * (1.0 - cap.busy_s() / done / (win.seconds / win.units))
