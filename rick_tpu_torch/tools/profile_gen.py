"""Device-time breakdown of the 256px forward slice on one GPU.

    python -m rick_tpu_torch.tools.profile_gen

Builds a seeded Generator(256) / Discriminator(256) on the card, warms up,
then profiles one random-noise generation at batch 100 (the evaluator's
256px batch, as in chip_smoke.py) and one D forward at batch 16 under
`torch.profiler`.  Prints, per phase, the wall time, the summed device time,
the device busy share and the kernels by device time.  TF32 is off, as in
chip_smoke.py.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from rick_tpu_torch.nn import Discriminator, Generator
from rick_tpu_torch.ops import _build

GEN_BATCH = 100
D_BATCH = 16
TOP = 15


def _profile(label: str, fn) -> None:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.device_time_total, e.count, e.key) for e in kernels), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"== {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    for us, count, key in rows[:TOP]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / max(busy_ms, 1e-9):5.1f}%  x{count:<4d} {key[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_gen needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    g = Generator(256, rng=gen, device=dev).eval()
    d = Discriminator(256, rng=gen, device=dev).eval()
    z = torch.randn((GEN_BATCH, 512), generator=gen, device=dev)
    nrng = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        x = g([z], rng=nrng)[0][:D_BATCH].contiguous()
        _profile(f"generate_b{GEN_BATCH}", lambda: g([z], rng=nrng))
        _profile(f"d_forward_b{D_BATCH}", lambda: d(x))


if __name__ == "__main__":
    main()
