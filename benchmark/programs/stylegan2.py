"""StyleGAN2 in the port: `rick_tpu_torch/nn/generator.py` and
`nn/discriminator.py`, in rosinality's layout, built from a configuration
file's keys as the port's train CLI builds them."""

from __future__ import annotations

from rick_tpu_torch.nn import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig


def generator(cfg: dict, device, rng):
    """(G, its GeneratorConfig), the constructor's draws from `rng`."""
    gcfg = GeneratorConfig(cfg["size"], cfg["style_dim"], cfg["n_mlp"], cfg["channel_multiplier"],
                           tuple(cfg["blur_kernel"]), cfg["lr_mlp"])
    g = Generator(gcfg.size, gcfg.style_dim, gcfg.n_mlp, gcfg.channel_multiplier, gcfg.blur_kernel, gcfg.lr_mlp,
                  rng=rng, device=device)
    return g, gcfg


def discriminator(cfg: dict, device, rng):
    """(D, its DiscriminatorConfig), the constructor's draws from `rng`."""
    dcfg = DiscriminatorConfig(cfg["d_size"], cfg["d_channel_multiplier"], tuple(cfg["blur_kernel"]),
                               cfg["stddev_group"])
    d = Discriminator(dcfg.size, dcfg.channel_multiplier, dcfg.blur_kernel, dcfg.stddev_group, rng=rng, device=device)
    return d, dcfg
