#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rick_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  0. print the card (nvidia-smi name, power limit); exit non-zero without CUDA
  1. build the CUDA kernels of `rick_tpu_torch/csrc` (one nvcc call)
  2. per kernel: compare with its plain PyTorch version at every shape the
     256px G/D forward gives it (batch 4, TF32 off), and time both
  3. the slice: seeded 256px G and D on the card, saved and loaded back as a
     rosinality {g, g_ema, d} checkpoint, then sample_images on 25 fixed
     latents, a batch-100 random-noise generation and D on 16 of the images;
     every kernel must have launched in that run
  4. the slice vs the plain path: the same weights on the CPU, where the port
     takes the plain versions; G (fixed latents, constant noise, and a mixing
     call) and D compared within 1e-3 * max|ref|
  5. generation img/s at batch 100 and D forward ms at batch 16

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from rick_tpu_torch.ckpt import load_checkpoint
from rick_tpu_torch.nn import Discriminator, Generator
from rick_tpu_torch.ops import (
    _build,
    convt_blur_act,
    convt_blur_act_ref,
    fused_bias_act,
    fused_bias_act_ref,
    launch_counts,
    modconv_epilogue,
    modconv_epilogue_ref,
    reset_launch_counts,
)
from rick_tpu_torch.train import sample_images

SIZE = 256
B = 4  # batch of the per-kernel checks
GEN_BATCH = 100  # the evaluator's 256px generation batch
D_BATCH = 16
SLICE_TOL = 1e-3  # slice vs plain: max|d| <= SLICE_TOL * max|ref|, TF32 off
# per-kernel: max|d| <= tol * max|ref|.  K1 and K3 are elementwise (at most an
# FMA contraction apart); K4 sums 9*Cin products in another order than cuDNN.
KERNEL_TOL = {"fused_bias_act": 1e-6, "modconv_epilogue": 1e-6, "convt_blur_act": 1e-4}
SOURCES = {
    "fused_bias_act": ("rick_tpu_torch/csrc/fused_bias_act.cu", "rick_tpu/ops/pallas_kernels.py:81"),
    "modconv_epilogue": ("rick_tpu_torch/csrc/modconv_epilogue.cu", "rick_tpu/ops/pallas_kernels.py:176"),
    "convt_blur_act": ("rick_tpu_torch/csrc/convt_blur_act.cu", "rick_tpu/ops/fused_upsample.py:257"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    d = float((got.double() - ref.double()).abs().max())
    return d, d / max(float(ref.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: every kernel at every main-path shape
# ---------------------------------------------------------------------------


def kernel_cases(gen: torch.Generator):
    """(kernel name, shape label, kernel call, plain call) at the shapes of
    the 256px G/D forward, batch B."""
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) + 0.5

    cases = []
    # K1: G style MLP / D head (B, 512); D ConvLayers (B, C, R, R)
    k1 = [(B, 512), (B, 128, 256, 256), (B, 256, 128, 128), (B, 512, 64, 64),
          (B, 512, 32, 32), (B, 512, 16, 16), (B, 512, 8, 8), (B, 512, 4, 4)]
    for shape in k1:
        x = randn(*shape)
        b = randn(shape[-1] if len(shape) == 2 else shape[1], scale=0.1)
        cases.append(("fused_bias_act", str(shape),
                      lambda x=x, b=b: fused_bias_act(x, b),
                      lambda x=x, b=b: fused_bias_act_ref(x, b)))
    # K3: the 7 non-upsample StyledConvs, noise batch B (fresh) and 1 (buffers)
    for C, R in [(512, 4), (512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256)]:
        out, demod, bias = randn(B, C, R, R), uniform(B, C), randn(C, scale=0.1)
        nw = torch.full((1,), 0.3, device=dev)
        for nb in (B, 1):
            noise = randn(nb, 1, R, R)
            cases.append(("modconv_epilogue", f"{(B, C, R, R)} noise batch {nb}",
                          lambda a=(out, demod, noise, nw, bias): modconv_epilogue(*a),
                          lambda a=(out, demod, noise, nw, bias): modconv_epilogue_ref(*a)))
    # K4: the 6 upsample StyledConvs (input H, Cin -> Cout)
    for H, cin, cout in [(4, 512, 512), (8, 512, 512), (16, 512, 512), (32, 512, 512),
                         (64, 512, 256), (128, 256, 128)]:
        xs = randn(B, cin, H, H)
        w = randn(cout, cin, 3, 3, scale=1.0 / (cin * 9) ** 0.5)
        demod, bias = uniform(B, cout), randn(cout, scale=0.1)
        for nb in (B, 1):
            noise = randn(nb, 1, 2 * H, 2 * H, scale=0.1)
            a = (xs, w, demod, noise, bias)
            cases.append(("convt_blur_act", f"{(B, cin, H, H)}->{cout} noise batch {nb}",
                          lambda a=a: convt_blur_act(*a),
                          lambda a=a: convt_blur_act_ref(*a)))
    return cases


def check_kernels() -> dict:
    """Per kernel: the largest error over its shapes, and the times at its
    costliest shape (by plain time)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    with torch.inference_mode():
        for name, label, kern, plain in kernel_cases(gen):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            require(got.shape == ref.shape, f"{name} {label}: shape {got.shape} != {ref.shape}")
            require(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
            abs_err, rel = rel_err(got, ref)
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            print(f"  {name:17s} {label:40s} max_abs_err={abs_err:.3e} rel={rel:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
            require(rel <= KERNEL_TOL[name], f"{name} {label}: rel err {rel:.3e} > {KERNEL_TOL[name]}")
            rows.append(dict(kernel=name, shape=label, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms))
            del got, ref
    per_kernel = {}
    for name in KERNEL_TOL:
        mine = [r for r in rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["plain_ms"])
        per_kernel[name] = dict(max_abs_err=max(r["max_abs_err"] for r in mine),
                                ms=top["ms"], plain_ms=top["plain_ms"], shape=top["shape"])
    return per_kernel


# ---------------------------------------------------------------------------
# phase 3-5: the slice
# ---------------------------------------------------------------------------


@torch.no_grad()
def randomize_zero_params(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Biases and noise weights start at zero: give them small random values
    so that the slice exercises the bias and noise paths."""
    for p in module.parameters():
        if not bool(p.any()):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.1)


def build_and_reload(tmpdir: str):
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    g = Generator(SIZE, rng=gen, device=dev)
    d = Discriminator(SIZE, rng=gen, device=dev)
    randomize_zero_params(g, gen)
    randomize_zero_params(d, gen)
    g_ema = copy.deepcopy(g)
    path = str(Path(tmpdir) / "ckpt.pt")
    torch.save({"g": g.state_dict(), "g_ema": g_ema.state_dict(), "d": d.state_dict()}, path)

    gen2 = torch.Generator(device=dev).manual_seed(1)
    g2, g_ema2 = Generator(SIZE, rng=gen2, device=dev), Generator(SIZE, rng=gen2, device=dev)
    d2 = Discriminator(SIZE, rng=gen2, device=dev)
    load_checkpoint(path, dev, g=g2, g_ema=g_ema2, d=d2)
    for src, dst in ((g, g2), (g_ema, g_ema2), (d, d2)):
        a, b = src.state_dict(), dst.state_dict()
        require(a.keys() == b.keys(), "checkpoint round trip changed the keys")
        require(all(torch.equal(a[k], b[k]) for k in a), "checkpoint round trip changed a tensor")
    return g_ema2.eval(), d2.eval()


def run_slice(g_ema, d) -> dict:
    dev = "cuda"
    zgen = torch.Generator(device=dev).manual_seed(2)
    z25 = torch.randn((25, g_ema.cfg.style_dim), generator=zgen, device=dev)
    z100 = torch.randn((GEN_BATCH, g_ema.cfg.style_dim), generator=zgen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        grid = sample_images(g_ema, z25)
        imgs, _ = g_ema([z100], rng=torch.Generator(device=dev).manual_seed(3))
        score, feats = d(imgs[:D_BATCH])
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  launches in the slice run: {counts}", flush=True)
    require(tuple(grid.shape) == (25, 3, SIZE, SIZE), f"sample grid shape {tuple(grid.shape)}")
    require(tuple(imgs.shape) == (GEN_BATCH, 3, SIZE, SIZE), f"images shape {tuple(imgs.shape)}")
    require(tuple(score.shape) == (D_BATCH, 1), f"D score shape {tuple(score.shape)}")
    for name, t in [("grid", grid), ("images", imgs), ("score", score)] + [(f"D feat {i}", f) for i, f in enumerate(feats)]:
        require(bool(torch.isfinite(t).all()), f"non-finite values in {name}")
    require(all(v > 0 for v in counts.values()), f"a kernel did not launch on the main path: {counts}")
    return counts


def slice_vs_plain(g_ema, d) -> None:
    """The same weights on the CPU, where every kernel wrapper takes its
    plain version; compared with the card's outputs on the same inputs."""
    g_cpu, d_cpu = copy.deepcopy(g_ema).cpu(), copy.deepcopy(d).cpu()
    zgen = torch.Generator().manual_seed(4)
    za = torch.randn((2, g_ema.cfg.style_dim), generator=zgen)
    zb = torch.randn((2, g_ema.cfg.style_dim), generator=zgen)
    worst = 0.0
    with torch.inference_mode():
        runs = {
            "fixed": lambda g, dev: g([za.to(dev)], return_feats=True),
            "mixing inject_index=3": lambda g, dev: g([za.to(dev), zb.to(dev)], inject_index=3, return_feats=True),
        }
        for label, run in runs.items():
            img_c, feats_c = run(g_cpu, "cpu")
            img_g, feats_g = run(g_ema, "cuda")
            pairs = [("image", img_g, img_c)] + [(f"feat {i}", a, b) for i, (a, b) in enumerate(zip(feats_g, feats_c))]
            if label == "fixed":
                s_c, df_c = d_cpu(img_c)
                s_g, df_g = d(img_c.cuda())
                pairs += [("D score", s_g, s_c)] + [(f"D feat {i}", a, b) for i, (a, b) in enumerate(zip(df_g, df_c))]
            for name, got, ref in pairs:
                _, rel = rel_err(got.cpu(), ref)
                worst = max(worst, rel)
                require(rel <= SLICE_TOL, f"slice vs plain, {label}, {name}: {rel:.3e} > {SLICE_TOL}")
            print(f"  {label}: {len(pairs)} tensors, worst max|d|/max|ref| = {worst:.3e}", flush=True)


def measure(g_ema, d, card: str) -> None:
    dev = "cuda"
    zgen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn((GEN_BATCH, g_ema.cfg.style_dim), generator=zgen, device=dev)
    nrng = torch.Generator(device=dev).manual_seed(6)
    with torch.inference_mode():
        g_ema([z], rng=nrng)
        torch.cuda.synchronize()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            imgs, _ = g_ema([z], rng=nrng)
        torch.cuda.synchronize()
        gen_s = (time.perf_counter() - t0) / iters
        x = imgs[:D_BATCH].contiguous()
        d_ms = cuda_ms(lambda: d(x), iters=10)
    rate = GEN_BATCH / gen_s
    print(f"  generation 256px batch {GEN_BATCH}: {rate:.1f} img/s ({gen_s * 1e3:.1f} ms/batch) [{card}]")
    print(f"  D forward 256px batch {D_BATCH}: {d_ms:.2f} ms [{card}]")
    print(f"  peak device memory of the run: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def main() -> int:
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"  nvcc build {_build.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s total", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    print(f"[2] kernels vs plain, batch {B}, TF32 off", flush=True)
    per_kernel = check_kernels()

    print("[3] slice: 256px G/D, checkpoint round trip, sample grid, batch-100 generation, D", flush=True)
    with tempfile.TemporaryDirectory() as tmpdir:
        g_ema, d = build_and_reload(tmpdir)
    counts = run_slice(g_ema, d)

    print(f"[4] slice vs plain (CPU), tolerance {SLICE_TOL} * max|ref|", flush=True)
    slice_vs_plain(g_ema, d)

    print("[5] timing", flush=True)
    measure(g_ema, d, card)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        k = per_kernel[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=counts[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"], shape=k["shape"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
