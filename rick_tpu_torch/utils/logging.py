"""Training telemetry: `stats.jsonl` scalars, wandb when asked for and
importable, and a `torch.profiler` trace window.  Port of
`rick_tpu/utils/logging.py`."""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Dict

import torch

from rick_tpu_torch.utils import trace


class StatsLogger:
    def __init__(self, output_path: str, *, use_wandb: bool = False, project: str = "", run_name: str = ""):
        self._path = os.path.join(output_path, "stats.jsonl")
        os.makedirs(output_path, exist_ok=True)
        self._fh = open(self._path, "a")
        self._t0 = time.time()
        self._wandb = None
        if use_wandb and importlib.util.find_spec("wandb") is not None:
            import wandb

            self._wandb = wandb
            wandb.init(project=project or "rick-tpu", name=run_name or None, reinit=True)

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **scalars}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def close(self):
        self._fh.close()


class ProfilerHook:
    """A `torch.profiler` trace (host and, on the card, device activity) of
    iterations [start_iter, start_iter + num_iters), written to `trace_dir`
    as a Chrome trace, with the program's spans (`utils/trace.py`) in it:
    the window runs inside `trace.recording()`, whose counters are written
    beside the trace (their host times hold the profiler's own cost).  A
    loop that ends inside the window calls `close()`, which writes what was
    traced up to there."""

    def __init__(self, trace_dir: str, start_iter: int = 10, num_iters: int = 5):
        self.trace_dir = trace_dir
        self.start_iter = start_iter
        self.stop_iter = start_iter + num_iters
        self._prof = None
        self._rec = None

    def step(self, i: int):
        if not self.trace_dir:
            return
        if i == self.start_iter and self._prof is None:
            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._rec = trace.recording()
            self._rec.__enter__()
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif i == self.stop_iter:
            self.close(i)

    def close(self, i: int):
        """Write the open window's trace, the loop having left it at
        iteration `i` (exclusive); nothing if no window is open."""
        if self._prof is None:
            return
        self._prof.stop()
        self._rec.__exit__(None, None, None)
        name = f"{self.start_iter}_{i}"
        self._prof.export_chrome_trace(os.path.join(self.trace_dir, f"trace_{name}.json"))
        with open(os.path.join(self.trace_dir, f"counters_{name}.json"), "w") as f:
            json.dump({k: {"calls": calls, "host_ns": ns} for k, (calls, ns) in trace.counters().items()}, f)
        self._prof = self._rec = None
