"""StyleGAN3-T in the port: `rick_tpu_torch/nn/stylegan3.py` (`Generator3`,
NVlabs' layout), built from a configuration file's keys; D is StyleGAN2's
(`nn/discriminator.py`) at the configuration's sizes."""

from __future__ import annotations

import dataclasses

from benchmark.programs.stylegan2 import discriminator  # noqa: F401  (the contract's second function)
from rick_tpu_torch.nn import Generator3, Generator3Config


def generator(cfg: dict, device, rng):
    """(G, its Generator3Config), the constructor's draws from `rng`."""
    gcfg = Generator3Config(**{f.name: cfg[f.name] for f in dataclasses.fields(Generator3Config)})
    return Generator3(gcfg, rng=rng, device=device), gcfg
