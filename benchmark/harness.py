"""One run of one cell: set-up, the measured window, the check of what the
window's path produced against the plain reference, and the result line.

A cell's traffic file names its runner (`benchmark/<kind>_cell.py`), which
provides:

    setup(ctx) -> program            build, warm up every shape of the cell
    window(ctx, program, seconds) -> Window
    end_to_end(window) -> {metric: value} of the cell's end-to-end metrics
    observe(ctx, program, window) -> observations of what the path produced
    reference(ctx, obs_or_none, tf32=False) -> the reference's observations
    compare(obs, ref) -> {number: value}, each held to limits/<workload>.json

The reference runs after the window has closed, the peak memory has been
read and the program's state has been freed.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

from benchmark import spec

# modules that no run may load, compared by their whole top-level name:
# the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "rick_tpu")
# every cache of the program and of PyTorch, at fixed paths inside the checkout
CACHE_DIRS = {
    "CUDA_CACHE_PATH": "build/bench_cache/cuda",
    "TRITON_CACHE_DIR": "build/bench_cache/triton",
    "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "build/bench_cache/inductor",
}


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs(repo: Path = spec.REPO) -> None:
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(repo / rel)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Window:
    """What a window did: its e2e metric, its work and, traced, its records."""

    seconds: float
    units: int  # evaluations or iterations completed
    failed: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)  # host span durations, s
    work: Dict[str, int] = field(default_factory=dict)  # units of work completed in the window, by kind
    capture: Optional[object] = None  # trace.Capture of the traced unit, run after the window
    traced_work: Dict[str, int] = field(default_factory=dict)  # units of work in the traced unit
    launches: List[tuple] = field(default_factory=list)  # port kernel launches in the traced unit
    extra: dict = field(default_factory=dict)


@dataclass
class Record:
    """What a per-layer reader sees."""

    window: Window
    flops: dict

    @property
    def capture(self):
        return self.window.capture


def card() -> dict:
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    power = out.stdout.strip().splitlines()[0].partition(",")[2] if out.returncode == 0 else ""
    return {"kind": torch.cuda.get_device_name(0), "power_limit": power.strip() or "not read"}


def make_ctx(workload: str, seed: int, trace: bool, device: str, bench: Optional[dict] = None,
             root: Path = spec.ROOT) -> SimpleNamespace:
    bench = bench if bench is not None else spec.load_benchmark()
    w = spec.workload(bench, workload)
    traffic = spec.traffic(w["traffic"], root)
    return SimpleNamespace(
        workload=workload, seed=seed, trace=trace, device=device, bench=bench, cell=w,
        cfg=spec.config(w["config"], root), traffic=traffic, flops=spec.flops(w["config"], w["traffic"], root),
        limits=spec.limits(workload, root), runner=spec.cell_runner(traffic["kind"]), root=root,
    )


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared at or under its limit (and a number at all)."""
    return all(math.isfinite(checks[k]) and checks[k] <= limits[k] for k in limits)


def tf32(on: bool) -> None:
    """TF32 in cuDNN's convolutions and cuBLAS's matmuls on or off (the
    program runs with it off, as the train CLI; the control with it on)."""
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(ctx, seconds: float) -> dict:
    """Set up, measure, check; returns the result line as a dict."""
    import torch

    program = ctx.runner.setup(ctx)
    setup_s = process_age_s()
    win = ctx.runner.window(ctx, program, seconds)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    obs = ctx.runner.observe(ctx, program, win)
    del program
    free_device()
    checks = ctx.runner.compare(obs, ctx.runner.reference(ctx, obs))
    e2e = {"setup_s": setup_s, **ctx.runner.end_to_end(win)}
    if ctx.trace:
        record = Record(win, ctx.flops)
        metrics = {}
        for m in spec.per_layer_for(ctx.bench, ctx.workload):
            value = spec.metric_reader(m["name"], ctx.root).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end_for(ctx.bench, ctx.workload)}
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": judge(checks, ctx.limits) and win.failed == 0, "attempted": win.units, "failed": win.failed,
              "metrics": metrics, "device": device}
    if ctx.trace and win.capture is not None:
        cap = win.capture
        device.update(busy_s=cap.busy_s(), window_s=cap.window_s)
        result["breakdown"] = {"device_ops": cap.device_ops(), "idle_gaps": cap.idle_gaps()}
    result["setup_s"] = setup_s
    result["window"] = {"seconds": win.seconds, "units": win.units, **win.extra}
    result["checks"] = {k: {"value": checks[k], "limit": ctx.limits[k]} for k in ctx.limits}
    return result


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch

    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    ctx = make_ctx(args.workload, args.seed, bool(args.trace), "cuda", bench)
    result = run(ctx, args.seconds)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    info = card()
    result["device"]["kind"] = info["kind"]
    result["power_limit"] = info["power_limit"]
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
