"""Device-time breakdown of the 256px forward slice and of one evaluator
chunk on one GPU.

    python -m rick_tpu_torch.tools.profile_gen

Builds a seeded Generator(256) / Discriminator(256) on the card, warms up,
then profiles one random-noise generation at batch 100 (the evaluator's
256px batch, as in chip_smoke.py), one D forward at batch 16, and one chunk
of the FID evaluation (`Evaluator.activations`: batch-100 generation through
K4 and the full 299px InceptionV3 on the seeded init) and its Inception
part alone under `torch.profiler`; the evaluation is 50 such chunks.  Prints, per phase, the
wall time, the summed device time, the device busy share, the launches and
the kernels by device time.  TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from rick_tpu_torch.metrics import Evaluator
from rick_tpu_torch.nn import Discriminator, Generator
from rick_tpu_torch.ops import _build, bf16_launch_counts, launch_counts, reset_launch_counts

GEN_BATCH = 100
D_BATCH = 16
TOP = 15


def start_on_card(tool: str) -> str:
    """Fail without a GPU; else print and return the card's name and power
    limit, turn TF32 off (as chip_smoke.py does) and build the kernels."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool} needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    return card


def profile_phase(label: str, fn) -> None:
    """Run fn once to warm up, then once under the profiler; print the wall
    time, the device busy time and share, the kernel launches, the port's
    kernel launches and the kernels by device time."""
    fn()
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.device_time_total, e.count, e.key) for e in kernels), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"== {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall), {sum(r[1] for r in rows)} kernel launches")
    print(f"   port kernel launches: {launch_counts()}, bf16 instantiations {bf16_launch_counts()}")
    for us, count, key in rows[:TOP]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / max(busy_ms, 1e-9):5.1f}%  x{count:<5d} {key[:110]}")


def main() -> None:
    start_on_card("profile_gen")

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    g = Generator(256, rng=gen, device=dev).eval()
    d = Discriminator(256, rng=gen, device=dev).eval()
    z = torch.randn((GEN_BATCH, 512), generator=gen, device=dev)
    nrng = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        x = g([z], rng=nrng, fast=True)[0][:D_BATCH].contiguous()
        profile_phase(f"generate_b{GEN_BATCH}", lambda: g([z], rng=nrng, fast=True))
        profile_phase(f"d_forward_b{D_BATCH}", lambda: d(x))
    # the real set only fixes the statistics the FID compares with: two cached
    # rows stand in for it, so that no extraction runs here
    ev = Evaluator(g.cfg, fid_real_samples=np.zeros((1, 3, 256, 256), np.uint8), gen_batch=GEN_BATCH,
                   real_acts=np.zeros((2, 2048)), device=dev)
    profile_phase(f"eval_chunk_b{GEN_BATCH}", lambda: ev.activations(g, z, rng=nrng))
    with torch.inference_mode():
        imgs = g([z], rng=nrng, fast=True)[0]
        profile_phase(f"inception_b{GEN_BATCH}", lambda: ev.inception.pool3(imgs))


if __name__ == "__main__":
    main()
