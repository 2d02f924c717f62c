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
    as a Chrome trace."""

    def __init__(self, trace_dir: str, start_iter: int = 10, num_iters: int = 5):
        self.trace_dir = trace_dir
        self.start_iter = start_iter
        self.stop_iter = start_iter + num_iters
        self._prof = None

    def step(self, i: int):
        if not self.trace_dir:
            return
        if i == self.start_iter and self._prof is None:
            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif i == self.stop_iter and self._prof is not None:
            self._prof.stop()
            self._prof.export_chrome_trace(
                os.path.join(self.trace_dir, f"trace_{self.start_iter}_{self.stop_iter}.json"))
            self._prof = None
