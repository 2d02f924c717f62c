"""The inputs every cell makes from `--seed`: weights and images, on the
device, in a few large calls, and handed alike to the program and to the
reference.  Neither model's checkpoint is in the repository, and none may be
fetched, so the weights are drawn (the configuration files say so under
`assumed`)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from benchmark import spec
from benchmark.reference import inception as ref_inception

# separate streams of one seed
G_WEIGHTS, D_WEIGHTS, INCEPTION_WEIGHTS, IMAGES, FISHER_LATENTS, PICK = range(6)


def stream_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def draw(leaves: Iterable[Tuple[str, tuple, float, float]], seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """{name: randn * scale + shift} of each leaf, all from one draw."""
    leaves = list(leaves)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device), device=device)
    out = {}
    for (name, shape, scale, shift), part in zip(leaves, flat.split(sizes)):
        out[name] = (part * scale + shift).reshape(shape)
    return out


def model_leaves(module: torch.nn.Module, cfg: dict, init_rule):
    """(name, shape, scale, shift) of each leaf, by the architecture's `init_rule`."""
    return [(n, tuple(t.shape), *init_rule(n, cfg)) for n, t in module.state_dict().items()]


def gan_weights(cfg: dict, seed: int, device, root: Path = spec.ROOT):
    """(G's, D's) state dicts of the configuration's architecture and sizes."""
    arch = spec.reference_models(cfg, root)
    g, d = arch.models(cfg, device="meta")
    return (draw(model_leaves(g, cfg, arch.init_rule), seed, G_WEIGHTS, device),
            draw(model_leaves(d, cfg, arch.init_rule), seed, D_WEIGHTS, device))


def inception_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    return draw(ref_inception.leaves(), seed, INCEPTION_WEIGHTS, device)


def images(n: int, size: int, seed: int, stream: int, device) -> torch.Tensor:
    """(n, 3, size, size) uint8 pixels, uniform."""
    return torch.randint(0, 256, (n, 3, size, size), generator=generator(seed, stream, device), device=device,
                         dtype=torch.uint8)
