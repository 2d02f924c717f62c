"""The recipe's training iteration and Fisher round in plain PyTorch: the
yardstick for the training cells.

RICK's FFHQ-to-10-shot recipe past its warm-up, as rosinality's
`train.py` with RICK's Fisher-driven freezing and pruning
(`train_dynamic_update_prune.py`): the D step on the logistic loss, lazy R1
every `d_reg_every` iterations, the G step on the non-saturating loss, lazy
path length every `g_reg_every` with the batch shrunk by `path_batch_shrink`,
and the EMA of G and D after the last phase of each iteration.  Adam has
beta1 0; the gradients of frozen or pruned filters are zeroed before it, and
pruned filters are zeroed after it.  A Fisher round sums the squared
per-image gradients of the G and D losses over the EMA models and cuts
filter scores at percentiles into freeze and prune masks.

The random draws are worked out again from the seed, in the order the
recipe's trainer makes them on the device (`iteration_generator`,
`sample_draws`), and the few-shot batches likewise (`StagedBatches`): the
program's draws and batches are not read.  Nothing here imports the program.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.stylegan2 import Discriminator, Generator

PHASES_TAG, FISHER_TAG = 0, 3


def iteration_generator(device, seed: int, i: int, tag: int) -> torch.Generator:
    """The generator of iteration i's draws of kind `tag`."""
    s = np.random.SeedSequence([seed + 7, i, tag]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def layer_noise(g: Generator, batch: int, gen: torch.Generator, device) -> List[torch.Tensor]:
    return [torch.randn((batch, 1, g.noise_res(j), g.noise_res(j)), generator=gen, device=device)
            for j in range(g.num_layers)]


def sample_draws(gen: torch.Generator, g: Generator, mixing: float, batch: int, latent: int, device,
                 path: bool = False) -> dict:
    """Two latents, the style-mixing index (n_latent: no mixing), the layer
    noise and, for the path phase, the image-space noise / sqrt(H * W)."""
    z1 = torch.randn((batch, latent), generator=gen, device=device)
    z2 = torch.randn((batch, latent), generator=gen, device=device)
    mix = torch.rand((), generator=gen, device=device) < mixing
    inject = torch.randint(1, g.n_latent, (), generator=gen, device=device)
    inject = torch.where(mix, inject, torch.full_like(inject, g.n_latent))
    draws = dict(z1=z1, z2=z2, inject=inject, noise=layer_noise(g, batch, gen, device))
    if path:
        draws["noise_img"] = torch.randn((batch, 3, g.size, g.size), generator=gen, device=device) / math.sqrt(
            g.size * g.size)
    return draws


class StagedBatches:
    """The few-shot set's batches: epochs of `np.random.default_rng(seed)`
    permutations cut to whole batches, each image flipped horizontally where
    a uniform draw of a device generator seeded `seed + 13` is below 0.5.
    `images`: (n, 3, H, W) uint8 pixels."""

    def __init__(self, images: torch.Tensor, batch: int, seed: int, device):
        self.imgs = images.to(device).float() / 127.5 - 1.0
        self.batch, self.device = batch, device
        self.rng = np.random.default_rng(seed)
        self.flips = torch.Generator(device=device).manual_seed(seed + 13)
        self.order, self.pos = np.empty(0, np.int64), 0

    def __next__(self) -> torch.Tensor:
        n = self.imgs.shape[0]
        if self.pos + self.batch > len(self.order):
            perm = self.rng.permutation(n)
            self.order, self.pos = perm[: n - n % self.batch], 0
        idx = torch.from_numpy(self.order[self.pos: self.pos + self.batch].astype(np.int64)).to(self.device)
        self.pos += self.batch
        b = self.imgs[idx]
        flip = torch.rand((idx.shape[0],), generator=self.flips, device=self.device) < 0.5
        return torch.where(flip[:, None, None, None], b.flip(-1), b)


# ---------------------------------------------------------------------------
# Losses and the pieces of a phase
# ---------------------------------------------------------------------------


def d_logistic(real_pred, fake_pred):
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating(fake_pred):
    return F.softplus(-fake_pred).mean()


def g_trainable(name: str) -> bool:
    return name.startswith("convs.")


def d_trainable(name: str) -> bool:
    return name.startswith(("final_conv.", "final_linear.")) or (
        name.startswith("convs.") and not name.startswith("convs.0."))


def maskable(name: str) -> bool:
    """Whether the leaf has freeze and prune masks (see `mask_keys`)."""
    parts = name.split(".")
    if parts[0] != "convs":
        return False
    leaf = ".".join(parts[2:])
    return leaf in ("conv.weight", "conv.modulation.weight", "conv.modulation.bias") or (
        parts[1] != "0" and leaf in ("conv1.0.weight", "conv1.1.bias", "conv2.1.weight", "conv2.2.bias",
                                     "skip.1.weight"))


def mask_keys(g: Generator, d: Discriminator):
    """{name: filter count} of G's and D's maskable leaves."""
    gk, dk = {}, {}
    for i, blk in enumerate(g.convs):
        _, out_ch, in_ch = blk.conv.weight.shape[:3]
        gk[f"convs.{i}.conv.weight"] = out_ch
        gk[f"convs.{i}.conv.modulation.weight"] = in_ch
        gk[f"convs.{i}.conv.modulation.bias"] = in_ch
    dp = dict(d.named_parameters())
    for b in range(1, len(d.convs)):
        for leaf in ("conv1.0.weight", "conv1.1.bias", "conv2.1.weight", "conv2.2.bias", "skip.1.weight"):
            dk[f"convs.{b}.{leaf}"] = dp[f"convs.{b}.{leaf}"].shape[0]
    return gk, dk


def _keep(mask, x):
    shape = [1] * x.ndim
    shape[1 if x.ndim == 5 else 0] = -1
    return (1.0 - mask).reshape(shape)


def d_phase_loss(g, d, real, draws):
    with torch.no_grad():
        fake = g.synthesis(g.make_latent(draws["z1"], draws["z2"], draws["inject"]), draws["noise"])
    return d_logistic(d(real), d(fake))


def r1_phase_loss(d, real, r1: float, d_reg_every: int):
    """(the loss D steps on, the R1 value)."""
    real = real.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d(real).sum(), real, create_graph=True)
    value = grad.pow(2).reshape(grad.shape[0], -1).sum(dim=1).mean()
    return r1 / 2.0 * value * d_reg_every, value


def g_phase_loss(g, d, draws):
    fake = g.synthesis(g.make_latent(draws["z1"], draws["z2"], draws["inject"]), draws["noise"])
    return g_nonsaturating(d(fake))


def path_phase_loss(g, draws, mean_path_length, path_regularize: float, g_reg_every: int):
    """(the loss G steps on, penalty, mean length of the batch, the new running mean)."""
    with torch.no_grad():
        latent = g.make_latent(draws["z1"], draws["z2"], draws["inject"])
    latent.requires_grad_(True)
    fake = g.synthesis(latent, draws["noise"])
    (grad,) = torch.autograd.grad((fake * draws["noise_img"]).sum(), latent, create_graph=True)
    lengths = torch.sqrt((grad * grad).sum(dim=2).mean(dim=1))
    new_mean = mean_path_length + 0.01 * (lengths.mean() - mean_path_length)
    penalty = ((lengths - new_mean) ** 2).mean()
    return path_regularize * g_reg_every * penalty, penalty, lengths.mean(), new_mean.detach()


def fisher_losses(g_ema, d_ema, z, real, noise):
    """One Fisher image's (G loss, D loss) over the EMA models."""
    fake = g_ema.synthesis(g_ema.make_latent(z), noise)
    g_loss = g_nonsaturating(d_ema(fake))
    return g_loss, d_logistic(d_ema(real), d_ema(fake.detach()))


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


class Trainer:
    """The recipe's training state and loop over models holding the
    benchmark's weights.  `t`: the traffic file's settings."""

    def __init__(self, g: Generator, d: Discriminator, t: dict, seed: int, device):
        self.t, self.seed, self.device = t, seed, device
        self.g, self.d = g, d
        self.g_ema, self.d_ema = copy.deepcopy(g), copy.deepcopy(d)
        g_ratio = t["g_reg_every"] / (t["g_reg_every"] + 1)
        d_ratio = t["d_reg_every"] / (t["d_reg_every"] + 1)
        self.g_params = {n: p for n, p in g.named_parameters() if g_trainable(n)}
        self.d_params = {n: p for n, p in d.named_parameters() if d_trainable(n)}
        self.g_opt = torch.optim.Adam(list(self.g_params.values()), lr=t["lr"] * g_ratio, betas=(0.0, 0.99 ** g_ratio),
                                      eps=1e-8)
        self.d_opt = torch.optim.Adam(list(self.d_params.values()), lr=t["lr"] * d_ratio, betas=(0.0, 0.99 ** d_ratio),
                                      eps=1e-8)
        gk, dk = mask_keys(g, d)
        zeros = lambda keys: {k: torch.zeros(n, device=device) for k, n in keys.items()}  # noqa: E731
        self.g_freeze, self.g_prune, self.d_freeze, self.d_prune = zeros(gk), zeros(gk), zeros(dk), zeros(dk)
        self.mean_path_length = torch.zeros((), device=device)
        self.ema_accum = 0.5 ** (32.0 / (t["ema_kimg"] * 1000.0))

    def _step(self, opt, params, loss, freeze, prune, module):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        for (n, p), gr in zip(params.items(), grads):
            gr = torch.zeros_like(p) if gr is None else gr
            if n in freeze:
                gr = gr * _keep(torch.maximum(freeze[n], prune[n]), gr)
            p.grad = gr
        opt.step()
        for p in params.values():
            p.grad = None
        pp = dict(module.named_parameters())
        with torch.no_grad():
            for n, m in prune.items():
                pp[n].mul_(_keep(m, pp[n]))

    @torch.no_grad()
    def _ema(self):
        for e, m in ((self.g_ema, self.g), (self.d_ema, self.d)):
            ev = list(e.state_dict().values())
            torch._foreach_mul_(ev, self.ema_accum)
            torch._foreach_add_(ev, list(m.state_dict().values()), alpha=1.0 - self.ema_accum)

    def iteration(self, real: torch.Tensor, i: int) -> Dict[str, torch.Tensor]:
        t, dev = self.t, self.device
        gen = iteration_generator(dev, self.seed, i, PHASES_TAG)
        zero = torch.zeros((), device=dev)
        draws = sample_draws(gen, self.g, t["mixing"], real.shape[0], self.g.style_dim, dev)
        loss = d_phase_loss(self.g, self.d, real, draws)
        self._step(self.d_opt, self.d_params, loss, self.d_freeze, self.d_prune, self.d)
        out = {"d": loss.detach(), "r1": zero}
        if i % t["d_reg_every"] == 0:
            loss, value = r1_phase_loss(self.d, real, t["r1"], t["d_reg_every"])
            self._step(self.d_opt, self.d_params, loss, self.d_freeze, self.d_prune, self.d)
            out["r1"] = value.detach()
        path_fires = i % t["g_reg_every"] == 0
        draws = sample_draws(gen, self.g, t["mixing"], t["batch"], self.g.style_dim, dev)
        loss = g_phase_loss(self.g, self.d, draws)
        self._step(self.g_opt, self.g_params, loss, self.g_freeze, self.g_prune, self.g)
        out["g"] = loss.detach()
        if not path_fires:
            self._ema()
        out["path"] = out["path_length"] = zero
        if path_fires:
            b = max(1, t["batch"] // t["path_batch_shrink"])
            draws = sample_draws(gen, self.g, t["mixing"], b, self.g.style_dim, dev, path=True)
            loss, penalty, length, new_mean = path_phase_loss(self.g, draws, self.mean_path_length,
                                                              t["path_regularize"], t["g_reg_every"])
            self._step(self.g_opt, self.g_params, loss, self.g_freeze, self.g_prune, self.g)
            self._ema()
            self.mean_path_length = new_mean
            out["path"], out["path_length"] = penalty.detach(), length.detach()
        out["mean_path_length"] = self.mean_path_length
        return out

    def fisher_round(self, noises: torch.Tensor, reals: torch.Tensor, i: int, first: bool) -> None:
        """The round's FIMs and masks; freeze masks replaced, prune masks
        replaced at the first round and OR-merged after it."""
        t = self.t
        gen = iteration_generator(self.device, self.seed, i, FISHER_TAG)
        gp, dp = dict(self.g_ema.named_parameters()), dict(self.d_ema.named_parameters())
        fim_g = {k: torch.zeros_like(v) for k, v in gp.items()}
        fim_d = {k: torch.zeros_like(v) for k, v in dp.items()}
        for j in range(noises.shape[0]):
            noise = layer_noise(self.g_ema, 1, gen, self.device)
            g_loss, d_loss = fisher_losses(self.g_ema, self.d_ema, noises[j: j + 1], reals[j: j + 1], noise)
            for fims, params, loss in ((fim_g, gp, g_loss), (fim_d, dp, d_loss)):
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                for n, gr in zip(params, grads):
                    if gr is not None:
                        fims[n].addcmul_(gr, gr)
        denom = float(t["num_fisher_img"] * t["batch"])
        for fims in (fim_g, fim_d):
            for v in fims.values():
                v.div_(denom)
        gf, gpr, df, dpr = masks_from_fims(fim_g, fim_d, t["fisher_quantile"], t["prune_quantile"])
        self.g_freeze, self.d_freeze = gf, df
        if first:
            self.g_prune, self.d_prune = gpr, dpr
        else:
            self.g_prune = {k: torch.maximum(self.g_prune[k], gpr[k]) for k in gpr}
            self.d_prune = {k: torch.maximum(self.d_prune[k], dpr[k]) for k in dpr}


def _cuts(scores, fisher_quantile, prune_quantile):
    s = torch.cat(scores)
    q = torch.tensor([fisher_quantile / 100.0, prune_quantile / 100.0], dtype=s.dtype, device=s.device)
    return torch.quantile(s, q, interpolation="linear")


def masks_from_fims(fim_g, fim_d, fisher_quantile: float, prune_quantile: float):
    """(g_freeze, g_prune, d_freeze, d_prune): filters scored in three groups
    (G conv: the out-filter mean of the weight's FIM; G FC: (row mean of the
    modulation weight's FIM + its bias's) / 2; D: (filter mean of the
    weight's FIM + the paired bias's) / 2, skip weights alone), frozen above
    the `fisher_quantile` percentile of their group, pruned at or below the
    `prune_quantile` one (strictly below for D's skips)."""
    n_g = sum(1 for k in fim_g if k.startswith("convs.") and k.endswith(".conv.weight"))
    conv = [fim_g[f"convs.{i}.conv.weight"][0].mean(dim=(1, 2, 3)) for i in range(n_g)]
    fc = [(fim_g[f"convs.{i}.conv.modulation.weight"].mean(dim=1) + fim_g[f"convs.{i}.conv.modulation.bias"]) / 2.0
          for i in range(n_g)]
    cut_conv, prune_conv = _cuts(conv, fisher_quantile, prune_quantile)
    cut_fc, prune_fc = _cuts(fc, fisher_quantile, prune_quantile)
    gf, gp = {}, {}
    for i, (cs, fs) in enumerate(zip(conv, fc)):
        gf[f"convs.{i}.conv.weight"], gp[f"convs.{i}.conv.weight"] = (cs > cut_conv).float(), (cs <= prune_conv).float()
        for leaf in ("weight", "bias"):
            gf[f"convs.{i}.conv.modulation.{leaf}"] = (fs > cut_fc).float()
            gp[f"convs.{i}.conv.modulation.{leaf}"] = (fs <= prune_fc).float()

    def fmean(name):
        return fim_d[name].mean(dim=(1, 2, 3))

    n_d = sum(1 for k in fim_d if k.startswith("convs.") and k.endswith(".conv1.0.weight"))
    scores = {b: ((fmean(f"convs.{b}.conv1.0.weight") + fim_d[f"convs.{b}.conv1.1.bias"]) / 2.0,
                  (fmean(f"convs.{b}.conv2.1.weight") + fim_d[f"convs.{b}.conv2.2.bias"]) / 2.0,
                  fmean(f"convs.{b}.skip.1.weight")) for b in range(1, n_d + 1)}
    cut_d, prune_d = _cuts([s for trio in scores.values() for s in trio], fisher_quantile, prune_quantile)
    df, dp = {}, {}
    for b, (s1, s2, sk) in scores.items():
        for key, s in ((f"convs.{b}.conv1.0.weight", s1), (f"convs.{b}.conv1.1.bias", s1),
                       (f"convs.{b}.conv2.1.weight", s2), (f"convs.{b}.conv2.2.bias", s2)):
            df[key], dp[key] = (s > cut_d).float(), (s <= prune_d).float()
        df[f"convs.{b}.skip.1.weight"] = (sk > cut_d).float()
        dp[f"convs.{b}.skip.1.weight"] = (sk < prune_d).float()
    return gf, gp, df, dp


def first_grads(opt: torch.optim.Adam, params: Dict[str, torch.nn.Parameter]) -> Dict[str, torch.Tensor]:
    """The gradient each leaf gave Adam at its one step so far: with beta1 0,
    the first moment is that gradient."""
    return {n: opt.state[p]["exp_avg"] for n, p in params.items() if p in opt.state}

