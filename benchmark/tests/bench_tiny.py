"""A small copy of the benchmark's data for CPU runs of its cells: the
configurations' layer kinds at 16px, a 40-sample evaluation through a cut
Inception, and the recipe's loop with a shorter cadence.  The limits are the
real cells' own, so a fault that passes them here would pass them there."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

TRAIN, FID = "tiny-train", "tiny-fid"


def make(dst: Path) -> dict:
    """Copy the benchmark's data under `dst` with the tiny cells added;
    returns the BENCHMARK.json that names them."""
    for sub in ("configs", "traffic", "flops", "limits", "metrics", "reference", "programs"):
        shutil.copytree(spec.ROOT / sub, dst / sub, dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = spec.config("stylegan2-ffhq256")
    cfg.update(name="tiny", size=16, d_size=16)
    (dst / "configs" / "tiny.json").write_text(json.dumps(cfg))
    fid = spec.traffic("fid5k")
    fid.update(inception_nsamples=40, gen_batch=10, real_samples=40, real_batch=10, ref_batch=10,
               inception_stop_at="Mixed_5b", inception_resize_to=75)
    (dst / "traffic" / f"{FID}.json").write_text(json.dumps(fid))
    train = spec.traffic("recipe-train")
    train.update(block=5, fisher_freq=5, log_every=5, d_reg_every=4, g_reg_every=2)
    (dst / "traffic" / f"{TRAIN}.json").write_text(json.dumps(train))
    shutil.copy(dst / "limits" / "ffhq256-fid5k.json", dst / "limits" / f"{FID}.json")
    shutil.copy(dst / "limits" / "ffhq256-train.json", dst / "limits" / f"{TRAIN}.json")
    for name in (FID, TRAIN):
        (dst / "flops" / f"tiny.{name}.json").write_text(json.dumps({"evaluation": 1} if name == FID else
                                                                   {k: 1 for k in ("d", "r1", "g", "path",
                                                                                   "fisher_round")}))
    bench = spec.load_benchmark()
    bench["workloads"] += [{"name": n, "config": "tiny", "traffic": n, "chips": 1, "why": "CPU test"} for n in (FID, TRAIN)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(FID if "fid5k_s" in (m["name"], m.get("moves")) else TRAIN)
    return bench
