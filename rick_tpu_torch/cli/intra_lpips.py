"""Stand-alone intra-cluster LPIPS: `python -m rick_tpu_torch.cli.intra_lpips`,
the flags and output lines of `rick_tpu.cli.intra_lpips` (the protocol of
`gan_training/eval.py:83-220`).  Port of `rick_tpu/cli/intra_lpips.py`.

  prepare <images> <out_dir>: write the cluster-center layout
    (`{out_dir}/c{k}/center.png`) from the K few-shot target images, which
    are the centers in this adaptation protocol;
  compute <samples> <centers>: intra-LPIPS of an image directory / `.npy`,
    or of `--n_samples` images that g_ema of a rosinality `.pt` (the train
    CLI's `best.pt`, say) generates at `--size`, in batches of 25 latents
    and noise from a `torch.Generator` seeded with `--seed` (`rick_tpu`
    draws them from `jax.random.key(seed)`), through the fused upsample
    kernel.

It runs on the card (`main(argv, device="cpu")` on the CPU), TF32 off,
VGG16 and the 'lin' weights from `RICK_VGG16_WEIGHTS` / `RICK_LPIPS_WEIGHTS`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rick_tpu_torch.ckpt import load_checkpoint
from rick_tpu_torch.cli.fid import _load_images, no_tf32
from rick_tpu_torch.metrics import IntraLPIPS, load_cluster_centers, prepare_cluster_centers
from rick_tpu_torch.nn import Generator, GeneratorConfig

SAMPLE_BATCH = 25


def sample_checkpoint(path: str, size: int, n: int, seed: int, device) -> torch.Tensor:
    """n images, f32 on `device`, of g_ema of the `.pt` at `path`."""
    gcfg = GeneratorConfig(size=size)
    gen = torch.Generator(device=device).manual_seed(seed)
    g_ema = Generator(gcfg.size, gcfg.style_dim, gcfg.n_mlp, gcfg.channel_multiplier, rng=gen, device=device)
    load_checkpoint(path, device, g_ema=g_ema)
    outs, got = [], 0
    with torch.inference_mode():
        while got < n:
            z = torch.randn((SAMPLE_BATCH, gcfg.style_dim), generator=gen, device=device)
            imgs, _ = g_ema([z], rng=gen, fast=True)
            outs.append(imgs.float())
            got += imgs.shape[0]
    return torch.cat(outs)[:n]


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description="intra-cluster LPIPS diversity")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("prepare", help="write c{k}/center.png layout")
    pp.add_argument("images", type=str, help="few-shot image dir / .npy / record store")
    pp.add_argument("out_dir", type=str, help="cluster-center dir to create")
    pp.add_argument("--size", type=int, default=256)

    pc = sub.add_parser("compute", help="intra-LPIPS of samples vs centers")
    pc.add_argument("samples", type=str,
                    help="generated-sample dir / .npy, OR a .pt checkpoint (g_ema key) to sample from")
    pc.add_argument("centers", type=str, help="cluster-center dir (c{k}/center.png)")
    pc.add_argument("--size", type=int, default=256)
    pc.add_argument("--k", type=int, default=10)
    pc.add_argument("--n_samples", type=int, default=1000)
    pc.add_argument("--cluster_size", type=int, default=50)
    pc.add_argument("--batch", type=int, default=8)
    pc.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    no_tf32()

    if args.cmd == "prepare":
        imgs = _load_images(args.images, args.size)
        prepare_cluster_centers(imgs, args.out_dir)
        print(f"wrote {imgs.shape[0]} centers under {args.out_dir}/c*/center.png")
        return

    device = torch.empty(0, device=device).device
    if args.samples.endswith(".pt"):
        samples = sample_checkpoint(args.samples, args.size, args.n_samples, args.seed, device)
    else:
        samples = _load_images(args.samples, args.size)[: args.n_samples]
    centers = load_cluster_centers(args.centers, k=args.k, size=args.size)
    il = IntraLPIPS(centers, cluster_size=args.cluster_size, batch=args.batch, device=device)
    val = il.compute(samples, rng=np.random.default_rng(args.seed))
    print(f"intra-LPIPS: {val:.6f}")


if __name__ == "__main__":
    main()
