"""The training iteration and the sample grids.  Port of `rick_tpu/train/steps.py`.

Phases: the D step, lazy R1, the G step, lazy path length, with the EMA
folded into the last phase of each iteration (the G phase, or the path phase
when it runs).  `rick_tpu` jits each phase and derives its random draws from
a key inside the jit; here each phase updates the `TrainState` in place and
takes its draws as tensors (`Draws`), which `sample_draws` makes from a
`torch.Generator` on the main path, and which a test can take from JAX.

The phases run G with `fast=False`, as JAX does: the upsample StyledConvs
take the differentiable chain (their activation is `fused_bias_act`, K1 and
its backward K2), the others `modconv_epilogue` (K3).  R1 and path length
differentiate through those kernels twice; JAX's path phase falls back to
its XLA epilogue there (`no_pallas_epilogue`), which is the same math.

With `tcfg.augment`, the D phase runs D on the ADA augment (`augment/`) of
its real and fake batch, augmented in one call, and adapts p after its step
(unless `augment_p` fixes it); the G phase augments its fakes, differentiably,
at the p the D phase left.  The R1 phase takes the D phase's augmented reals;
the path phase has no augment, as in JAX.

Warmup (`i < warmup_iter`): D steps only `final*`, G does not step (its loss
is still computed), and the path phase does not run.  Adam's per-param step
counts advance only for the params that step (`train/adam.py`).

With `tcfg.bf16`, the D and G phases run G and D with the compute dtype
bf16 (`compute_dtype`), as rick_tpu's `make_train_step`: G's image and D's
scores come back f32 (both promote after their first layer) and are cast to
f32 before ADA and the losses all the same.  Params, gradients, Adam, the
EMA, ADA, R1 and path length stay f32.

With a process `group` (`dist/`, one rank per card), every draw is made at
the global batch on every rank, from the same generator, and each rank keeps
its rows (`local_draws`); its real batch is its rows of the global one.
Each phase all-reduces its gradient dict to the mean, in one flat buffer per
model, before the masks and Adam, so that the ranks take the same steps and
keep equal state (`init_train_state` and `replicate_train_state` start them
equal).  What spans the batch spans the global batch, as in XLA: D's
minibatch stddev (a twice-differentiable gather), ADA's sign sum and count,
the path-length mean, and the losses and scores returned.  A path batch that
does not divide by the world size (1 in the recipe) runs whole on every
rank, and rank 0's gradients are broadcast in place of the all-reduce.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Union

import torch

from rick_tpu_torch.augment import augment, sample_affine, sample_color
from rick_tpu_torch.dist import (
    Group,
    all_gather_rows,
    average_,
    local_rows,
    reduce_mean,
    reduce_sum,
    replicate,
    world_size,
)
from rick_tpu_torch.nn import GeneratorConfig
from rick_tpu_torch.train.adam import Params, adam_step
from rick_tpu_torch.train.losses import d_logistic_loss, g_nonsaturating_loss, path_stats
from rick_tpu_torch.train.masks import d_final, d_trainable, g_trainable, mask_grads, prune_params
from rick_tpu_torch.train.state import TrainConfig, TrainState, trainable_params
from rick_tpu_torch.utils.trace import span


@dataclass
class Draws:
    """The random numbers of one phase."""

    z1: torch.Tensor  # (B, latent)
    z2: torch.Tensor  # (B, latent)
    inject_index: Union[torch.Tensor, int]  # layers >= it take z2's style; n_latent: no mixing
    noise: List[torch.Tensor]  # per layer, (B, 1, R, R)
    noise_img: Optional[torch.Tensor] = None  # path phase: (B, 3, H, W) / sqrt(H * W)
    ada_G: Optional[torch.Tensor] = None  # with augment: (n, 3, 3) affines of the images the phase augments
    ada_C: Optional[torch.Tensor] = None  # and their (n, 4, 4) colour matrices

    def to(self, device) -> "Draws":
        move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x  # noqa: E731
        return Draws(move(self.z1), move(self.z2), move(self.inject_index), [move(x) for x in self.noise],
                     move(self.noise_img), move(self.ada_G), move(self.ada_C))


def sample_draws(
    gen: torch.Generator,
    gcfg: GeneratorConfig,
    tcfg: TrainConfig,
    batch: int,
    *,
    path: bool = False,
    ada_p: Optional[torch.Tensor] = None,
    ada_batch: int = 0,
) -> Draws:
    """The draws of `rick_tpu`'s `_sample_latent` (style mixing with
    probability `tcfg.mixing`, inject index uniform in 1..n_latent-1),
    `_layer_noise`, and for the path phase the image-space noise, made on
    `gen`'s device.  The inject index stays a device tensor: no host sync.
    With `tcfg.augment` and `ada_batch` > 0 (2 * batch for the D phase, which
    augments reals and fakes, batch for the G phase), the ADA matrices of
    `ada_batch` images at probability `ada_p` follow, drawn last, so that a
    run without augment draws what it drew before ADA was ported."""
    dev = gen.device
    z1 = torch.randn((batch, tcfg.latent), generator=gen, device=dev)
    z2 = torch.randn((batch, tcfg.latent), generator=gen, device=dev)
    mix = torch.rand((), generator=gen, device=dev) < tcfg.mixing
    inject = torch.randint(1, gcfg.n_latent, (), generator=gen, device=dev)
    inject = torch.where(mix, inject, torch.full_like(inject, gcfg.n_latent))
    noise = [
        torch.randn((batch, 1, 2 ** ((j + 5) // 2), 2 ** ((j + 5) // 2)), generator=gen, device=dev)
        for j in range(gcfg.num_layers)
    ]
    noise_img = None
    if path:
        noise_img = torch.randn((batch, 3, gcfg.size, gcfg.size), generator=gen, device=dev)
        noise_img = noise_img / math.sqrt(gcfg.size * gcfg.size)
    ada_G = ada_C = None
    if tcfg.augment and ada_batch:
        ada_G = sample_affine(gen, ada_p, ada_batch, gcfg.size, gcfg.size)
        ada_C = sample_color(gen, ada_p, ada_batch)
    return Draws(z1, z2, inject, noise, noise_img, ada_G, ada_C)


def local_draws(draws: Draws, group: Group) -> Draws:
    """This rank's rows of draws made at the global batch B.  The D phase's
    ADA matrices (2B: the reals', then the fakes') keep this rank's rows of
    each half."""
    if group is None:
        return draws

    def rows(x):
        return None if x is None else local_rows(x, group)

    def ada(m):
        if m is None or m.shape[0] == draws.z1.shape[0]:
            return rows(m)
        half = m.shape[0] // 2
        return torch.cat([rows(m[:half]), rows(m[half:])])

    return Draws(rows(draws.z1), rows(draws.z2), draws.inject_index, [rows(x) for x in draws.noise],
                 rows(draws.noise_img), ada(draws.ada_G), ada(draws.ada_C))


def ada_update(ada_p, ada_stats, r_t, real_pred, tcfg: TrainConfig, group: Group = None):
    """ADA probability adaptation: pool sign(real_pred); once more than 255
    predictions are pooled, step p by sign(r_t - target) * ada_step * n and
    reset the pool.  With a process `group`, the sign sum and the count are
    the global batch's.  Returns (ada_p, ada_stats, r_t)."""
    count = torch.full((), real_pred.shape[0], dtype=ada_stats.dtype, device=ada_stats.device)
    stats = ada_stats + reduce_sum(torch.stack([torch.sign(real_pred).sum(), count]), group)
    trigger = stats[1] > 255
    r_t_new = stats[0] / torch.clamp(stats[1], min=1.0)
    sign = torch.where(r_t_new > tcfg.ada_target, 1.0, -1.0)
    p_new = torch.clamp(ada_p + sign * tcfg.ada_step * stats[1], 0.0, 1.0)
    return (
        torch.where(trigger, p_new, ada_p),
        torch.where(trigger, torch.zeros_like(stats), stats),
        torch.where(trigger, r_t_new, r_t),
    )


def _grads(loss: torch.Tensor, params: Params) -> Dict[str, torch.Tensor]:
    """d loss / d param for each param; zeros where the loss does not use it."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if gr is None else gr for (n, p), gr in zip(params.items(), got)}


def _synced_grads(loss: torch.Tensor, params: Params, group: Group, replicated: bool) -> Dict[str, torch.Tensor]:
    """`_grads`, then the mean over the ranks (one all-reduce), or with
    `replicated` (every rank computed the same batch) rank 0's."""
    grads = _grads(loss, params)
    if replicated:
        replicate(grads.values(), group)
    else:
        average_(grads.values(), group)
    return grads


def _d_step(state: TrainState, loss: torch.Tensor, warmup: bool, group: Group = None) -> None:
    active = trainable_params(state.d, d_final if warmup else d_trainable)
    grads = mask_grads(_synced_grads(loss, active, group, False), state.d_freeze, state.d_prune)
    adam_step(state.d_opt, trainable_params(state.d, d_trainable), grads)
    prune_params(state.d, state.d_prune)


def _g_step(state: TrainState, loss: torch.Tensor, warmup: bool, group: Group = None,
            replicated: bool = False) -> None:
    if not warmup:
        active = trainable_params(state.g, g_trainable)
        grads = _synced_grads(loss, active, group, replicated)
        adam_step(state.g_opt, active, mask_grads(grads, state.g_freeze, state.g_prune))
    prune_params(state.g, state.g_prune)


@torch.no_grad()
def ema(ema_module: torch.nn.Module, module: torch.nn.Module, accum: float) -> None:
    """e = accum * e + (1 - accum) * p over every param and buffer."""
    e = list(ema_module.state_dict().values())
    torch._foreach_mul_(e, accum)
    torch._foreach_add_(e, list(module.state_dict().values()), alpha=1.0 - accum)


def compute_dtype(tcfg: TrainConfig) -> torch.dtype:
    """The D and G phases' compute dtype: bf16 with `tcfg.bf16`, else f32."""
    return torch.bfloat16 if tcfg.bf16 else torch.float32


def _latent(g, draws: Draws) -> torch.Tensor:
    return g.make_latent([draws.z1, draws.z2], inject_index=draws.inject_index)


def _fake(g, latent: torch.Tensor, draws: Draws, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return g([latent], input_is_latent=True, noise=draws.noise, dtype=dtype)[0]


def _augment(tcfg: TrainConfig, img: torch.Tensor, p: torch.Tensor, draws: Draws) -> torch.Tensor:
    if draws.ada_G is None or draws.ada_C is None:
        raise ValueError("augment=True: the phase's draws carry no ADA matrices (sample_draws with ada_batch)")
    return augment(img, p, margin=tcfg.ada_margin, transform=(draws.ada_G, draws.ada_C))[0]


def d_phase(state: TrainState, tcfg: TrainConfig, real_img: torch.Tensor, draws: Draws, warmup: bool,
            group: Group = None):
    """D step on real_img and a fake batch, with augment both through one
    ADA call at the state's p, then (adaptive p) the p update.  Returns
    (metrics, the reals the R1 phase takes: the augmented ones).  With a
    process `group`, real_img and draws are this rank's rows."""
    with span("train.d"):
        cdt = compute_dtype(tcfg)
        with torch.no_grad():
            fake = _fake(state.g, _latent(state.g, draws), draws, cdt).float()
            real_aug, fake_aug = real_img, fake
            if tcfg.augment:
                both = _augment(tcfg, torch.cat([real_img, fake]), state.ada_p, draws)
                real_aug, fake_aug = both[: real_img.shape[0]], both[real_img.shape[0]:]
        fake_pred, _ = state.d(fake_aug, dtype=cdt, group=group)
        real_pred, _ = state.d(real_aug, dtype=cdt, group=group)
        real_pred, fake_pred = real_pred.float(), fake_pred.float()
        loss = d_logistic_loss(real_pred, fake_pred)
        _d_step(state, loss, warmup, group)
        if tcfg.augment and tcfg.augment_p == 0:
            state.ada_p, state.ada_stats, state.r_t = ada_update(
                state.ada_p, state.ada_stats, state.r_t, real_pred.detach(), tcfg, group)
        d, real_score, fake_score = reduce_mean(
            torch.stack([loss.detach(), real_pred.detach().mean(), fake_pred.detach().mean()]), group)
        metrics = {"d": d, "real_score": real_score, "fake_score": fake_score, "ada_p": state.ada_p, "r_t": state.r_t}
        return metrics, real_aug


def r1_phase(state: TrainState, tcfg: TrainConfig, real_img: torch.Tensor, warmup: bool,
             group: Group = None) -> torch.Tensor:
    """Lazy R1: r1 = mean over the batch of |d sum(D(x)) / dx|^2; D steps on
    r1 / 2 * r1 * d_reg_every.  Returns the r1 value.  With a process
    `group`, each rank's input gradient is that of the global sum (the
    stddev gather sums the cotangents over the ranks)."""
    with span("train.r1"):
        real = real_img.detach().requires_grad_(True)
        pred, _ = state.d(real, group=group)
        (grad_real,) = torch.autograd.grad(pred.sum(), real, create_graph=True)
        r1 = grad_real.pow(2).reshape(grad_real.shape[0], -1).sum(dim=1).mean()
        _d_step(state, tcfg.r1 / 2.0 * r1 * tcfg.d_reg_every, warmup, group)
        return reduce_mean(r1.detach(), group)


def g_phase(state: TrainState, tcfg: TrainConfig, draws: Draws, warmup: bool, do_ema: bool,
            group: Group = None) -> torch.Tensor:
    """G step on the non-saturating loss, with augment through the ADA warp
    at the state's p; with `do_ema`, the iteration's EMA of G and D.
    Returns the loss.  With a process `group`, draws are this rank's rows."""
    with span("train.g"):
        cdt = compute_dtype(tcfg)
        with torch.set_grad_enabled(not warmup):
            fake = _fake(state.g, _latent(state.g, draws), draws, cdt).float()  # ADA and D take f32
            if tcfg.augment:
                fake = _augment(tcfg, fake, state.ada_p, draws)
            pred, _ = state.d(fake, dtype=cdt, group=group)
            loss = g_nonsaturating_loss(pred.float())
        _g_step(state, loss, warmup, group)
        if do_ema:
            ema(state.g_ema, state.g, tcfg.ema_accum)
            ema(state.d_ema, state.d, tcfg.ema_accum)
        return reduce_mean(loss.detach(), group)


def path_phase(state: TrainState, tcfg: TrainConfig, draws: Draws, warmup: bool, group: Group = None,
               replicated: bool = False):
    """Lazy path-length step, then the iteration's EMA.  One forward: the
    gradient of sum(fake * noise_img) with respect to the latent keeps its
    graph, and G steps on path_regularize * g_reg_every * penalty.  Returns
    (penalty, mean path length of the batch).

    With a process `group`, draws are this rank's rows of the path batch;
    with `replicated`, every rank holds the whole path batch, computes what
    one process computes, and takes rank 0's gradients, penalty and mean."""
    with span("train.path"):
        stats_group = None if replicated else group
        with torch.no_grad():
            latent = _latent(state.g, draws)
        latent.requires_grad_(True)
        fake = _fake(state.g, latent, draws)
        (grad_lat,) = torch.autograd.grad((fake * draws.noise_img).sum(), latent, create_graph=True)
        penalty, new_mean, lengths = path_stats(grad_lat, state.mean_path_length, group=stats_group)
        _g_step(state, tcfg.path_regularize * tcfg.g_reg_every * penalty, warmup, group, replicated)
        ema(state.g_ema, state.g, tcfg.ema_accum)
        ema(state.d_ema, state.d, tcfg.ema_accum)
        out = torch.stack([reduce_mean(penalty.detach(), stats_group),
                           all_gather_rows(lengths.detach(), stats_group).mean(), new_mean])
        if replicated:
            replicate([out], group)
        state.mean_path_length = out[2].clone()
        return out[0], out[1]


def run_iteration(
    state: TrainState,
    tcfg: TrainConfig,
    real_img: torch.Tensor,
    i: int,
    *,
    gen: Optional[torch.Generator] = None,
    draws: Optional[Mapping[str, Draws]] = None,
    group: Group = None,
) -> Dict[str, torch.Tensor]:
    """One iteration i: the phases that fire, each with its draws from
    `draws` ("d", "g", "path") or, where a phase has none there, from
    `sample_draws(gen, ...)` in phase order, each phase's ADA matrices at
    the p it starts from.  Returns the metrics as device tensors (no host
    sync).

    With a process `group`, real_img is this rank's rows of the global
    batch, and the draws (given or sampled) are the global batch's: each
    phase takes this rank's rows of them."""
    with span("train.iteration"):
        draws = dict(draws or {})
        gcfg = state.g.cfg

        def phase_draws(phase: str, batch: int) -> Draws:
            if phase not in draws:
                ada_batch = {"d": 2 * batch, "g": batch}.get(phase, 0)
                draws[phase] = sample_draws(gen, gcfg, tcfg, batch, path=phase == "path", ada_p=state.ada_p,
                                            ada_batch=ada_batch)
            return draws[phase]

        warmup = i < tcfg.warmup_iter
        zero = torch.zeros((), device=real_img.device)
        world = world_size(group)
        d_draws = local_draws(phase_draws("d", real_img.shape[0] * world), group)
        metrics, real_aug = d_phase(state, tcfg, real_img, d_draws, warmup, group)

        metrics["r1"] = zero
        if i % tcfg.d_reg_every == 0:
            metrics["r1"] = r1_phase(state, tcfg, real_aug, warmup, group)

        # as in rick_tpu: no path phase during warmup, so neither G nor the mean
        # path length moves there
        path_fires = i % tcfg.g_reg_every == 0 and i >= tcfg.warmup_iter
        g_draws = local_draws(phase_draws("g", tcfg.batch), group)
        metrics["g"] = g_phase(state, tcfg, g_draws, warmup, do_ema=not path_fires, group=group)

        metrics["path"] = metrics["path_length"] = zero
        if path_fires:
            path_batch = max(1, tcfg.batch // tcfg.path_batch_shrink)
            replicated = group is not None and path_batch % world != 0
            p_draws = phase_draws("path", path_batch)
            if not replicated:
                p_draws = local_draws(p_draws, group)
            metrics["path"], metrics["path_length"] = path_phase(state, tcfg, p_draws, warmup, group, replicated)
        metrics["mean_path_length"] = state.mean_path_length
        return metrics


@torch.inference_mode()
def sample_images(g_ema, sample_z: torch.Tensor, *, chunk: int = 25) -> torch.Tensor:
    """Deterministic sample grid from fixed latents, in chunks of `chunk`.
    Uses the registered constant noise buffers, so grids are reproducible,
    and the fused upsample kernel (`fast=True`)."""
    outs = [g_ema([sample_z[i : i + chunk]], fast=True)[0] for i in range(0, sample_z.shape[0], chunk)]
    return torch.cat(outs, dim=0)
