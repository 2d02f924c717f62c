"""Latent distributions and spherical interpolation
(`gan_training/distributions.py:5-43`).  Port of
`rick_tpu/legacy/distributions.py`: the samplers draw from a
`torch.Generator` on its device, so their values are not `jax.random`'s."""

from __future__ import annotations

import torch


def get_zdist(dist_name: str, dim: int):
    """A sampler `sample(gen, n) -> (n, dim)` on `gen`'s device: 'gauss'
    (standard normal) or 'uniform' (in [-1, 1)); it carries `.dim`."""
    if dist_name == "gauss":
        def sample(gen: torch.Generator, n: int) -> torch.Tensor:
            return torch.randn((n, dim), generator=gen, device=gen.device)
    elif dist_name == "uniform":
        def sample(gen: torch.Generator, n: int) -> torch.Tensor:
            return torch.rand((n, dim), generator=gen, device=gen.device) * 2.0 - 1.0
    else:
        raise NotImplementedError(dist_name)
    sample.dim = dim
    return sample


def get_ydist(nlabels: int):
    """A uniform categorical label sampler `sample(gen, n) -> (n,)` int64;
    it carries `.nlabels`."""
    def sample(gen: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, nlabels, (n,), generator=gen, device=gen.device)

    sample.nlabels = nlabels
    return sample


def interpolate_sphere(z1: torch.Tensor, z2: torch.Tensor, t) -> torch.Tensor:
    """slerp between z1 and z2 along the last axis."""
    p = torch.sum(z1 * z2, dim=-1, keepdim=True)
    p = p / (torch.linalg.norm(z1, dim=-1, keepdim=True) * torch.linalg.norm(z2, dim=-1, keepdim=True))
    omega = torch.arccos(torch.clamp(p, -1.0, 1.0))
    s1 = torch.sin((1 - t) * omega) / torch.sin(omega)
    s2 = torch.sin(t * omega) / torch.sin(omega)
    return s1 * z1 + s2 * z2
