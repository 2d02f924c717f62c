"""Train configuration and state.  Port of `rick_tpu/train/state.py`.

`rick_tpu` keeps the whole mutable state in one pytree that its jitted
phases take and return; here it is one `TrainState` whose modules,
optimizers and tensors the phases of `train/steps.py` update in place.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from rick_tpu_torch.dist import Group, replicate
from rick_tpu_torch.nn import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
from rick_tpu_torch.train.adam import Params, make_adam
from rick_tpu_torch.train.masks import Masks, d_trainable, g_trainable, init_d_masks, init_g_masks


@dataclass(frozen=True)
class TrainConfig:
    """Static hyperparameters, the fields and defaults of `rick_tpu`'s."""

    batch: int = 2
    latent: int = 512
    r1: float = 10.0
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    d_reg_every: int = 16
    g_reg_every: int = 4
    mixing: float = 0.9
    lr: float = 0.002
    augment: bool = True
    augment_p: float = 0.0
    ada_target: float = 0.6
    ada_length: int = 500 * 1000
    ada_margin: int = 224
    warmup_iter: int = 250
    fisher_freq: int = 50
    num_fisher_img: int = 5
    fisher_quantile: float = 40.0
    prune_quantile: float = 0.1
    ema_kimg: float = 10.0  # accum = 0.5 ** (32 / (10 * 1000))
    bf16: bool = False

    @property
    def g_reg_ratio(self) -> float:
        return self.g_reg_every / (self.g_reg_every + 1)

    @property
    def d_reg_ratio(self) -> float:
        return self.d_reg_every / (self.d_reg_every + 1)

    @property
    def g_lr(self) -> float:
        return self.lr * self.g_reg_ratio

    @property
    def d_lr(self) -> float:
        return self.lr * self.d_reg_ratio

    @property
    def g_beta2(self) -> float:
        return 0.99**self.g_reg_ratio

    @property
    def d_beta2(self) -> float:
        return 0.99**self.d_reg_ratio

    @property
    def ema_accum(self) -> float:
        return 0.5 ** (32.0 / (self.ema_kimg * 1000.0))

    @property
    def ada_step(self) -> float:
        return self.ada_target / self.ada_length


def trainable_params(module: nn.Module, trainable) -> Params:
    """{name: param} of the params that `trainable(name)` selects."""
    return {n: p for n, p in module.named_parameters() if trainable(n)}


@dataclass
class TrainState:
    g: Generator
    d: Discriminator
    g_ema: Generator
    d_ema: Discriminator
    g_opt: torch.optim.Adam  # over trainable_params(g, g_trainable)
    d_opt: torch.optim.Adam  # over trainable_params(d, d_trainable)
    g_freeze: Masks
    g_prune: Masks
    d_freeze: Masks
    d_prune: Masks
    mean_path_length: torch.Tensor  # 0-d
    ada_p: torch.Tensor  # 0-d
    ada_stats: torch.Tensor  # (2,): sum of sign(real_pred), count
    r_t: torch.Tensor  # 0-d

    def to(self, device) -> "TrainState":
        """Move the whole state to `device`, in place; the optimizers keep
        their params.  Returns self."""
        for module in (self.g, self.d, self.g_ema, self.d_ema):
            module.to(device)
        for opt in (self.g_opt, self.d_opt):
            for st in opt.state.values():
                st["exp_avg"], st["exp_avg_sq"] = st["exp_avg"].to(device), st["exp_avg_sq"].to(device)
        for masks in (self.g_freeze, self.g_prune, self.d_freeze, self.d_prune):
            masks.update({k: v.to(device) for k, v in masks.items()})
        for k in ("mean_path_length", "ada_p", "ada_stats", "r_t"):
            setattr(self, k, getattr(self, k).to(device))
        return self


def init_train_state(
    gcfg: GeneratorConfig,
    dcfg: DiscriminatorConfig,
    tcfg: TrainConfig,
    *,
    rng: torch.Generator,
    device="cuda",
    g: Generator | None = None,
    d: Discriminator | None = None,
) -> TrainState:
    """The full training state on `device` (the card unless the caller asks
    for the CPU).  G and D are drawn from `rng` unless given; the EMA copies
    are distinct modules.  `tcfg.bf16` changes no part of the state: it
    stays f32, as rick_tpu's (the phases cast where they compute)."""
    if g is None:
        g = Generator(
            gcfg.size, gcfg.style_dim, gcfg.n_mlp, gcfg.channel_multiplier, gcfg.blur_kernel,
            gcfg.lr_mlp, rng=rng, device=device,
        )
    if d is None:
        d = Discriminator(
            dcfg.size, dcfg.channel_multiplier, dcfg.blur_kernel, dcfg.stddev_group,
            dcfg.stddev_feat, rng=rng, device=device,
        )
    g, d = g.to(device), d.to(device)

    def zero(*shape):
        return torch.zeros(shape, device=device)

    return TrainState(
        g=g,
        d=d,
        g_ema=copy.deepcopy(g),
        d_ema=copy.deepcopy(d),
        g_opt=make_adam(trainable_params(g, g_trainable), lr=tcfg.g_lr, beta2=tcfg.g_beta2),
        d_opt=make_adam(trainable_params(d, d_trainable), lr=tcfg.d_lr, beta2=tcfg.d_beta2),
        g_freeze=init_g_masks(g),
        g_prune=init_g_masks(g),
        d_freeze=init_d_masks(d),
        d_prune=init_d_masks(d),
        mean_path_length=zero(),
        ada_p=torch.full((), tcfg.augment_p if tcfg.augment_p > 0 else 0.0, device=device),
        ada_stats=zero(2),
        r_t=zero(),
    )


def replicate_train_state(state: TrainState, group: Group) -> None:
    """In place: rank 0's whole state on every rank of `group` (params and
    buffers of the four models, Adam's moments and step counts, the masks,
    the path and ADA state), in one broadcast per dtype and device.  The
    ranks must hold states of one structure, as `init_train_state` or a
    resume from one file makes them."""
    if group is None:
        return
    tensors = [t for m in (state.g, state.d, state.g_ema, state.d_ema) for t in m.state_dict().values()]
    steps = []
    for opt in (state.g_opt, state.d_opt):
        for p in opt.param_groups[0]["params"]:
            if p in opt.state:
                st = opt.state[p]
                tensors += [st["exp_avg"], st["exp_avg_sq"]]
                steps.append(st["step"])
    for masks in (state.g_freeze, state.g_prune, state.d_freeze, state.d_prune):
        tensors += list(masks.values())
    tensors += [state.mean_path_length, state.ada_p, state.ada_stats, state.r_t]
    replicate(tensors, group)
    if steps:  # Adam keeps its step counts on the host: they travel on the device as f64
        counts = torch.tensor([float(c) for c in steps], dtype=torch.float64, device=state.ada_p.device)
        replicate([counts], group)
        for c, v in zip(steps, counts.tolist()):
            c.fill_(v)
