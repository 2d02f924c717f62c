"""Device-time breakdown of the 256px batch-2 training phases on one GPU.

    python -m rick_tpu_torch.tools.profile_train [--bf16]

Builds a seeded Generator(256) / Discriminator(256) training state on the
card (`TrainConfig(batch=2, augment=False)`, after warmup; `--bf16` sets
`bf16=True`, the D and G phases' compute dtype), runs each phase
once to warm up, then profiles one D, R1, G and path-length phase and one
Fisher round (5 images) under `torch.profiler`.  Prints, per phase, the
wall time, the summed device time, the device busy share, the kernels by
device time, and the launches of the port's kernels.  TF32 is off, as in
chip_smoke.py.
"""

from __future__ import annotations

import argparse

import torch

from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
from rick_tpu_torch.tools.profile_gen import profile_phase, start_on_card
from rick_tpu_torch.train import TrainConfig, fisher_round, init_train_state, sample_draws
from rick_tpu_torch.train import steps

SIZE = 256
N_FISHER = 5


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="device-time breakdown of the 256px batch-2 training phases")
    p.add_argument("--bf16", action="store_true", help="bf16 compute in the D and G phases, as train --bf16")
    args = p.parse_args(argv)
    start_on_card("profile_train")

    dev = "cuda"
    gcfg, dcfg = GeneratorConfig(SIZE), DiscriminatorConfig(SIZE)
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=0, bf16=args.bf16)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(gcfg, dcfg, tcfg, rng=gen, device=dev)
    real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=dev)
    path_batch = max(1, tcfg.batch // tcfg.path_batch_shrink)
    noises = torch.randn((N_FISHER, tcfg.latent), generator=gen, device=dev)
    reals = torch.randn((N_FISHER, 3, SIZE, SIZE), generator=gen, device=dev)
    phases = {
        "d_phase": lambda: steps.d_phase(state, tcfg, real, sample_draws(gen, gcfg, tcfg, tcfg.batch), False),
        "r1_phase": lambda: steps.r1_phase(state, tcfg, real, False),
        "g_phase": lambda: steps.g_phase(state, tcfg, sample_draws(gen, gcfg, tcfg, tcfg.batch), False, True),
        "path_phase": lambda: steps.path_phase(
            state, tcfg, sample_draws(gen, gcfg, tcfg, path_batch, path=True), False),
        f"fisher_round_{N_FISHER}": lambda: fisher_round(
            state.g_ema, state.d_ema, noises, reals, batch=tcfg.batch,
            fisher_quantile=tcfg.fisher_quantile, prune_quantile=tcfg.prune_quantile, gen=gen),
    }
    for label, fn in phases.items():
        profile_phase(f"{label} ({SIZE}px, batch {tcfg.batch}{', bf16' if tcfg.bf16 else ''})", fn)


if __name__ == "__main__":
    main()
