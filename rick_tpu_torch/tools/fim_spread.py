"""How closely the card's Fisher accumulation can match the CPU's, per FIM.

    python -m rick_tpu_torch.tools.fim_spread [--pairs 4]

Builds a seeded 256px training state on the card as `chip_smoke.py` phase 7
does (biases and noise weights drawn non-zero, iterations 0, 1, 4 and 16 at
batch 2), then, for each of `--pairs` pairs of seeded images, accumulates
the FIMs of g_ema and d_ema with the constant noise: on the CPU, on the CPU
with the inputs scaled by 1 + 1e-6, and twice on the card.  Prints, for
every one-element FIM (G's noise weights, D's final bias), its size and
three relative errors against the CPU (card, CPU perturbed, card against
card), the same for the one-element FIMs of G as one vector, and the worst
tensor FIMs.  TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import copy

import torch

from rick_tpu_torch.nn import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
from rick_tpu_torch.tools.profile_gen import start_on_card
from rick_tpu_torch.train import TrainConfig, accumulate_fims, init_train_state, run_iteration

SIZE = 256
ITERS = (0, 1, 4, 16)


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.detach().double().cpu()
    return float((got.detach().double().cpu() - ref).norm() / ref.norm())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=4)
    args = parser.parse_args()
    start_on_card("fim_spread")

    dev = "cuda"
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=1)
    wgen = torch.Generator(device=dev).manual_seed(10)
    g, d = Generator(SIZE, rng=wgen, device=dev), Discriminator(SIZE, rng=wgen, device=dev)
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, generator=wgen, device=dev) * 0.1)
    state = init_train_state(GeneratorConfig(SIZE), DiscriminatorConfig(SIZE), tcfg, rng=wgen, device=dev, g=g, d=d)
    gen = torch.Generator(device=dev).manual_seed(11)
    for i in ITERS:
        run_iteration(state, tcfg, torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=dev), i, gen=gen)
    cpu = copy.deepcopy(state).to("cpu")

    def fims(s, noises, reals):
        return accumulate_fims(s.g_ema, s.d_ema, noises, reals, batch=tcfg.batch, const_noise=True)

    for pair in range(args.pairs):
        pgen = torch.Generator().manual_seed(100 + pair)
        noises = torch.randn((2, tcfg.latent), generator=pgen)
        reals = torch.randn((2, 3, SIZE, SIZE), generator=pgen)
        want = fims(cpu, noises, reals)
        pert = fims(cpu, noises * (1 + 1e-6), reals * (1 + 1e-6))
        got = fims(state, noises.to(dev), reals.to(dev))
        again = fims(state, noises.to(dev), reals.to(dev))
        print(f"pair {pair}: FIM relative errors against the CPU (card, CPU with inputs x(1+1e-6), card vs card)")
        tensors = []
        for model, a, a2, b, p in zip(("g_ema", "d_ema"), got, again, want, pert):
            ones = [k for k in b if b[k].numel() == 1]
            for k in sorted(ones, key=lambda k: -rel(a[k], b[k])):
                print(f"  {model}.{k:<28} |FIM| {float(b[k]):.3e}  {rel(a[k], b[k]):.2e}  {rel(p[k], b[k]):.2e}  "
                      f"{rel(a2[k], a[k]):.2e}")
            if model == "g_ema":
                vec = [torch.stack([t[k].reshape(()).double().cpu() for k in ones]) for t in (a, a2, b, p)]
                print(f"  {model} one-element FIMs as one vector: {rel(vec[0], vec[2]):.2e}  "
                      f"{rel(vec[3], vec[2]):.2e}  {rel(vec[1], vec[0]):.2e}")
            tensors += [(rel(a[k], b[k]), f"{model}.{k}", rel(p[k], b[k])) for k in b if b[k].numel() > 1]
        for e, k, ep in sorted(tensors, reverse=True)[:3]:
            print(f"  worst tensor {k}: {e:.2e}  {ep:.2e}")


if __name__ == "__main__":
    main()
