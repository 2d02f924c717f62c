"""Fisher information and the freeze / fine-tune / prune decisions.  Port of
`rick_tpu/train/fisher.py`.

`accumulate_fims` sums, over N batch-1 images, the squared gradients of the
per-image G and D losses with respect to every param of g_ema and d_ema, and
divides by `denom` (by default N * batch: the reference divides by
num_fisher_img * batch, whatever the rows per file, and `rick_tpu` keeps
that).  `masks_from_fims` scores filters in three groups, takes percentile
cutlines (`torch.quantile`, linear, as `jnp.percentile`), and returns the
freeze and prune masks keyed as `train/masks.py` keys them.

With a process `group` whose size divides N, the images are sharded as
`rick_tpu`'s `mesh=` path shards them: each rank sums the squared gradients
of its block of images, and one all-reduce adds the sums, squared before
they are reduced (the first JAX version reduced first and squared the sum).
Otherwise every rank runs the whole round and takes rank 0's sums, so the
masks are equal on every rank either way.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rick_tpu_torch.dist import Group, process_batch_slice, replicate, sum_, world_size
from rick_tpu_torch.train.losses import d_logistic_loss, g_nonsaturating_loss
from rick_tpu_torch.train.masks import Masks
from rick_tpu_torch.utils.trace import span

Fims = Dict[str, torch.Tensor]


def _add_squares(acc: Fims, params: Dict[str, torch.nn.Parameter], loss: torch.Tensor) -> None:
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    for name, gr in zip(params, grads):
        if gr is not None:
            acc[name].addcmul_(gr, gr)


def accumulate_fims(
    g_ema,
    d_ema,
    noises: torch.Tensor,
    reals: torch.Tensor,
    *,
    batch: int,
    denom: Optional[float] = None,
    const_noise: bool = False,
    gen: Optional[torch.Generator] = None,
    group: Group = None,
) -> Tuple[Fims, Fims]:
    """Average squared per-image gradients {name: FIM} of g_ema and d_ema.

    noises (N, latent), reals (N, 3, H, W).  Image i's G loss is
    g_nonsaturating(d_ema(g_ema(z_i))) and its D loss
    d_logistic(d_ema(real_i), d_ema(g_ema(z_i))).  The injection noise is the
    registered constant buffers with `const_noise=True`, else fresh per
    image from `gen`: every rank draws every image's, so that image i takes
    the same noise however the images are sharded.  With a process `group`,
    noises and reals are the whole set on every rank (see the module's
    docstring)."""
    n = noises.shape[0]
    denom = float(n * batch) if denom is None else float(denom)
    sharded = group is not None and n % world_size(group) == 0
    start, size = process_batch_slice(n, group) if sharded else (0, n)
    gp, dp = dict(g_ema.named_parameters()), dict(d_ema.named_parameters())
    fim_g = {k: torch.zeros_like(v) for k, v in gp.items()}
    fim_d = {k: torch.zeros_like(v) for k, v in dp.items()}
    for i in range(n):
        noise = None if const_noise else g_ema.layer_noise(1, gen, None)
        if not start <= i < start + size:
            continue
        fake, _ = g_ema([noises[i : i + 1]], noise=noise)
        _add_squares(fim_g, gp, g_nonsaturating_loss(d_ema(fake)[0]))
        fake_pred, _ = d_ema(fake.detach())
        real_pred, _ = d_ema(reals[i : i + 1])
        _add_squares(fim_d, dp, d_logistic_loss(real_pred, fake_pred))
    sums = list(fim_g.values()) + list(fim_d.values())
    if sharded:
        sum_(sums, group)
    else:
        replicate(sums, group)
    for fims in (fim_g, fim_d):
        for v in fims.values():
            v.div_(denom)
    return fim_g, fim_d


def _percentiles(scores, fisher_quantile: float, prune_quantile: float):
    grouped = torch.cat(scores)
    q = torch.tensor([fisher_quantile / 100.0, prune_quantile / 100.0], dtype=grouped.dtype, device=grouped.device)
    cut, prune = torch.quantile(grouped, q, interpolation="linear")
    return cut, prune


def masks_from_fims(
    fim_g: Fims, fim_d: Fims, *, fisher_quantile: float, prune_quantile: float
) -> Tuple[Masks, Masks, Masks, Masks]:
    """(g_freeze, g_prune, d_freeze, d_prune).  Groups, each with its own
    cutlines: G conv (per out-filter mean of the conv weight FIM), G FC
    ((row mean of the modulation weight FIM + its bias FIM) / 2 per input
    channel), and D conv ((filter mean of the weight FIM + the paired bias
    FIM) / 2, the skip weights scored alone).  Freeze is score > the
    `fisher_quantile` percentile, prune is score <= the `prune_quantile`
    percentile, but < for the D skip weights."""
    n_g = sum(1 for k in fim_g if k.startswith("convs.") and k.endswith(".conv.weight"))
    conv = [fim_g[f"convs.{i}.conv.weight"][0].mean(dim=(1, 2, 3)) for i in range(n_g)]
    fc = [
        (fim_g[f"convs.{i}.conv.modulation.weight"].mean(dim=1) + fim_g[f"convs.{i}.conv.modulation.bias"]) / 2.0
        for i in range(n_g)
    ]
    cut_conv, prune_conv = _percentiles(conv, fisher_quantile, prune_quantile)
    cut_fc, prune_fc = _percentiles(fc, fisher_quantile, prune_quantile)
    g_freeze, g_prune = {}, {}
    for i, (cs, fs) in enumerate(zip(conv, fc)):
        g_freeze[f"convs.{i}.conv.weight"] = (cs > cut_conv).float()
        g_prune[f"convs.{i}.conv.weight"] = (cs <= prune_conv).float()
        for leaf in ("weight", "bias"):
            g_freeze[f"convs.{i}.conv.modulation.{leaf}"] = (fs > cut_fc).float()
            g_prune[f"convs.{i}.conv.modulation.{leaf}"] = (fs <= prune_fc).float()

    def filter_mean(name):
        return fim_d[name].mean(dim=(1, 2, 3))

    n_d = sum(1 for k in fim_d if k.startswith("convs.") and k.endswith(".conv1.0.weight"))
    scores = {}  # block -> (conv1, conv2, skip)
    for b in range(1, n_d + 1):
        s1 = (filter_mean(f"convs.{b}.conv1.0.weight") + fim_d[f"convs.{b}.conv1.1.bias"]) / 2.0
        s2 = (filter_mean(f"convs.{b}.conv2.1.weight") + fim_d[f"convs.{b}.conv2.2.bias"]) / 2.0
        scores[b] = (s1, s2, filter_mean(f"convs.{b}.skip.1.weight"))
    cut_d, prune_d = _percentiles([s for trio in scores.values() for s in trio], fisher_quantile, prune_quantile)
    d_freeze, d_prune = {}, {}
    for b, (s1, s2, sk) in scores.items():
        for key, s in ((f"convs.{b}.conv1.0.weight", s1), (f"convs.{b}.conv1.1.bias", s1),
                       (f"convs.{b}.conv2.1.weight", s2), (f"convs.{b}.conv2.2.bias", s2)):
            d_freeze[key] = (s > cut_d).float()
            d_prune[key] = (s <= prune_d).float()
        d_freeze[f"convs.{b}.skip.1.weight"] = (sk > cut_d).float()
        d_prune[f"convs.{b}.skip.1.weight"] = (sk < prune_d).float()  # strict, as rick_tpu
    return g_freeze, g_prune, d_freeze, d_prune


def fisher_round(
    g_ema,
    d_ema,
    noises: torch.Tensor,
    reals: torch.Tensor,
    *,
    batch: int,
    fisher_quantile: float,
    prune_quantile: float,
    denom: Optional[float] = None,
    const_noise: bool = False,
    gen: Optional[torch.Generator] = None,
    group: Group = None,
) -> Tuple[Masks, Masks, Masks, Masks]:
    """FIM accumulation and the mask decisions: (g_freeze, g_prune,
    d_freeze, d_prune).  The caller replaces its freeze masks and merges the
    prune masks (`masks.merge_prune`).  `group`: see `accumulate_fims`."""
    with span("fisher.round"):
        fim_g, fim_d = accumulate_fims(
            g_ema, d_ema, noises, reals, batch=batch, denom=denom, const_noise=const_noise, gen=gen, group=group,
        )
        return masks_from_fims(fim_g, fim_d, fisher_quantile=fisher_quantile, prune_quantile=prune_quantile)
