"""The readings that a cell's limits are set from, on the card at the cell's
own size:

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--program] [--seconds S]
                                 [--fault half_batch,altered] [--no-control]

For each seed, the control is the reference put in the program's place and
computed in the precision below the configuration's (TF32 for float32 with
TF32 off), held to the reference in float32 by the cell's own comparison:
it has to come out above the limits.  With `--program`, the program's
readings on the same seed too (set-up, a window of `--seconds`, the check),
which have to come out under them; with `--fault`, the program's with each
fault of `benchmark/faults.py` planted, which set the upper ends of the
numbers the control does not fail.  One JSON line per seed; the benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import faults, harness


def program_obs(ctx, seconds: float, fault: str = ""):
    """The program's observations after set-up and a window of `seconds`
    (none at 0), with `fault` planted if named."""
    with faults.planted(ctx.traffic["kind"], fault) if fault else contextlib.nullcontext():
        prog = ctx.runner.setup(ctx)
        win = ctx.runner.window(ctx, prog, seconds) if seconds > 0 else None  # a training cell checks its set-up
        obs = ctx.runner.observe(ctx, prog, win)
    del prog
    harness.free_device()
    return obs


def readings(workload: str, seed: int, program: bool, seconds: float, fault_names=(), control: bool = True,
             device: str = "cuda", bench=None, **kw) -> dict:
    ctx = harness.make_ctx(workload, seed, False, device, bench, **kw)
    out = {"seed": seed}
    obs = program_obs(ctx, seconds) if program else {"call": 1}
    planted = {f: program_obs(ctx, seconds, f) for f in fault_names}
    refs = {}

    def reference(o):  # the reference of an evaluation `call` (one for a training cell's steps)
        if o.get("call") not in refs:
            refs[o.get("call")] = ctx.runner.reference(ctx, o)
        return refs[o.get("call")]

    ref = reference(obs)
    if program:
        out["program"] = ctx.runner.compare(obs, ref)
    for f, fault_obs in planted.items():
        out[f"fault:{f}"] = ctx.runner.compare(fault_obs, reference(fault_obs))
    if control:
        out["control"] = ctx.runner.compare(ctx.runner.reference(ctx, obs, tf32=True), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", default="", help="comma-separated faults of benchmark/faults.py to read too")
    p.add_argument("--no-control", dest="control", action="store_false")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    names = [f for f in args.fault.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.program, args.seconds, names, args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
