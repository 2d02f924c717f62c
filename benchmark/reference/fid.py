"""FID@N in plain PyTorch, the yardstick for the evaluation cell: the
evaluation's draws worked out again from the seed, generation by the plain
generator, pool3 by the plain InceptionV3, statistics and the Fréchet
distance in float64.

The draws are those of RICK's in-loop evaluator as the recipe's trainer
makes them: the samples of evaluation number `call` come in blocks of
`block` rows, block b's latents and then its layer noise drawn from a device
generator seeded by `SeedSequence([seed, call, 0, b])`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.inception import InceptionPool3
from benchmark.reference.train import layer_noise


def block_draws(g: nn.Module, seed: int, call: int, b: int, block: int, device):
    s = np.random.SeedSequence([seed, call, 0, b]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(s))
    z = torch.randn((block, g.style_dim), generator=gen, device=device)
    return z, layer_noise(g, block, gen, device)


def stats64(acts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, cov) in float64, ddof 1."""
    x = acts.double()
    mu = x.mean(dim=0)
    xc = x - mu
    return mu, xc.T @ xc / (x.shape[0] - 1)


def frechet64(mu1, s1, mu2, s2) -> float:
    """|mu1 - mu2|^2 + tr S1 + tr S2 - 2 tr sqrtm(S1 S2), in float64, with
    tr sqrtm(S1 S2) = tr sqrt(A S2 A) for A = sqrtm(S1), both symmetric
    square roots by eigendecomposition, eigenvalues clipped at 0."""
    mu1, s1, mu2, s2 = (torch.as_tensor(a).double() for a in (mu1, s1, mu2, s2))
    w, v = torch.linalg.eigh(s1)
    a = (v * w.clamp_min(0).sqrt()) @ v.T
    m = a @ s2 @ a
    tr = torch.linalg.eigvalsh((m + m.T) / 2).clamp_min(0).sqrt().sum()
    diff = mu1 - mu2
    return float(diff @ diff + s1.trace() + s2.trace() - 2 * tr)


@torch.no_grad()
def fake_acts(g: nn.Module, inception: InceptionPool3, *, seed: int, call: int, n: int, block: int, device):
    """pool3 activations (n, 2048) of evaluation `call`'s draws."""
    out = []
    for b in range(n // block):
        z, noise = block_draws(g, seed, call, b, block, device)
        out.append(inception(g(z, noise)).float())
    return torch.cat(out)


@torch.no_grad()
def real_acts(inception: InceptionPool3, images: torch.Tensor, batch: int) -> torch.Tensor:
    """pool3 activations of uint8 images, in batches (a partial last batch dropped)."""
    out = []
    for i in range(images.shape[0] // batch):
        x = images[i * batch: (i + 1) * batch].float() / 127.5 - 1.0
        out.append(inception(x).float())
    return torch.cat(out)
