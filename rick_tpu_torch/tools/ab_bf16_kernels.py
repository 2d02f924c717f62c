"""K1-bf16 and K3-bf16 of this checkout against those of another checkout of
the port (e.g. a `git archive` of an earlier commit), by device time.

    python -m rick_tpu_torch.tools.ab_bf16_kernels --other build/parent

Each side runs in a process of its own, with its checkout's `rick_tpu_torch`
first on the path (each builds its kernels into its own `build/`), in the order
other, this, this, other.  A side times the wrappers `fused_bias_act` on a
bf16 x at D's from-RGB shape (2,128,256,256) and `modconv_epilogue` on bf16
operands at G's conv1, (2,512,4,4) with noise batch 2 and 1, and at
(4,128,256,256): the device time of the CUDA kernels that 20 calls launch,
under torch.profiler, and a hash of each output.  The inputs are drawn from
one seed, so equal hashes mean bitwise equal outputs.  Run on the card; the
card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

CASES = ("k1 (2,128,256,256)", "k3 (2,512,4,4) noise 2", "k3 (2,512,4,4) noise 1", "k3 (4,128,256,256) noise 4")


def _device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one launch of the one CUDA kernel that each call
    of fn launches, under torch.profiler over `iters` calls, over the kernel
    records the profiler delivered (a session that delivers none is run
    again, up to ten times)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(10):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        launches = sum(e.count for e in kernels)
        if launches:
            return sum(e.device_time_total for e in kernels) / launches / 1000.0
    raise RuntimeError("the profiler delivered no kernel records in 10 sessions")


def probe(root: Path) -> dict:
    """One side: {case: (device ms, output hash)}, with the `rick_tpu_torch`
    of the checkout at `root` (first on the path; not imported before)."""
    sys.path.insert(0, str(root))
    import torch

    from rick_tpu_torch.ops import fused_bias_act, modconv_epilogue

    gen = torch.Generator(device="cuda").manual_seed(5)

    def epi(shape, nb):
        b, c, h, w = shape
        return (torch.randn(shape, generator=gen, device="cuda").bfloat16(),
                (torch.rand((b, c), generator=gen, device="cuda") + 0.5).bfloat16(),
                torch.randn((nb, 1, h, w), generator=gen, device="cuda").bfloat16(),
                torch.full((1,), 0.3, device="cuda").bfloat16(), torch.randn(c, generator=gen, device="cuda") * 0.1)

    x = torch.randn((2, 128, 256, 256), generator=gen, device="cuda").bfloat16()
    bias = torch.randn(128, generator=gen, device="cuda") * 0.1
    calls = dict(zip(CASES, (lambda: fused_bias_act(x, bias),
                             *(lambda a=epi(s, nb): modconv_epilogue(*a)
                               for s, nb in (((2, 512, 4, 4), 2), ((2, 512, 4, 4), 1), ((4, 128, 256, 256), 4))))))
    out = {}
    with torch.inference_mode():
        for case, fn in calls.items():
            digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
            out[case] = (_device_ms(fn), digest)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout (holding rick_tpu_torch/)")
    ap.add_argument("--probe", help=argparse.SUPPRESS)  # one side: the root of its checkout
    args = ap.parse_args(argv)
    if args.probe:
        print(json.dumps(probe(Path(args.probe))))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    roots = {"other": Path(args.other).resolve(), "this": Path(__file__).resolve().parents[2]}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--other", args.other,
                               "--probe", str(roots[side])], cwd=roots[side], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the {side} side failed:\n{proc.stdout}{proc.stderr}")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for case in CASES:
        ms = {side: [r[case][0] for r in rs] for side, rs in runs.items()}
        same = len({r[case][1] for rs in runs.values() for r in rs}) == 1
        print(f"  {case}: device ms other {[round(t, 5) for t in ms['other']]}, this "
              f"{[round(t, 5) for t in ms['this']]} (in turns other, this, this, other); outputs bitwise equal: "
              f"{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
