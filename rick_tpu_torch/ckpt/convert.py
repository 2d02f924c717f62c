"""rick_tpu parameter pytrees and train states -> the port's state dicts and
`TrainState`, and rosinality `.pt` checkpoint loading.  Port of
`rick_tpu/ckpt/convert.py`.

The converters take `rick_tpu`'s params as nested dicts and lists of arrays
(numpy, or anything `np.asarray` reads) and work in numpy only, so this
module imports neither jax nor any of `rick_tpu`.  Keys (rosinality layout):

  Generator:
    style.{1..n_mlp}.weight/bias, input.input (1, ch4, 4, 4)
    conv1.conv.weight (1, out, in, 3, 3), conv1.conv.modulation.weight/bias,
    conv1.noise.weight (1,), conv1.activate.bias
    to_rgb1.conv.weight (1, 3, in, 1, 1), .conv.modulation.*, .bias (1, 3, 1, 1)
    convs.{i}.<as conv1>, to_rgbs.{i}.<as to_rgb1>, noises.noise_{j}

  Discriminator:
    convs.0.0.weight / convs.0.1.bias
    convs.{b}.conv1.0.weight / .conv1.1.bias / .conv2.1.weight / .conv2.2.bias / .skip.1.weight
    final_conv.0.weight / final_conv.1.bias, final_linear.{0,1}.weight/bias
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from rick_tpu_torch.nn.discriminator import Discriminator, DiscriminatorConfig
from rick_tpu_torch.nn.generator import Generator, GeneratorConfig
from rick_tpu_torch.train.masks import d_trainable, g_trainable
from rick_tpu_torch.train.state import TrainConfig, TrainState, init_train_state, trainable_params


def _n(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _styled_to_sd(p, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.conv.weight"] = _n(p["conv"]["weight"])[None]
    out[f"{prefix}.conv.modulation.weight"] = _n(p["conv"]["modulation"]["weight"])
    out[f"{prefix}.conv.modulation.bias"] = _n(p["conv"]["modulation"]["bias"])
    out[f"{prefix}.noise.weight"] = _n(p["noise_weight"]).reshape(1)
    out[f"{prefix}.activate.bias"] = _n(p["act_bias"])


def _torgb_to_sd(p, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.conv.weight"] = _n(p["conv"]["weight"])[None]
    out[f"{prefix}.conv.modulation.weight"] = _n(p["conv"]["modulation"]["weight"])
    out[f"{prefix}.conv.modulation.bias"] = _n(p["conv"]["modulation"]["bias"])
    out[f"{prefix}.bias"] = _n(p["bias"])


def generator_state_dict_from_jax(cfg: GeneratorConfig, params) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params["style"]):
        sd[f"style.{i + 1}.weight"] = _n(layer["weight"])
        sd[f"style.{i + 1}.bias"] = _n(layer["bias"])
    sd["input.input"] = _n(params["input"])
    _styled_to_sd(params["conv1"], "conv1", sd)
    _torgb_to_sd(params["to_rgb1"], "to_rgb1", sd)
    for i, p in enumerate(params["convs"]):
        _styled_to_sd(p, f"convs.{i}", sd)
    for i, p in enumerate(params["to_rgbs"]):
        _torgb_to_sd(p, f"to_rgbs.{i}", sd)
    for j, nz in enumerate(params["noises"]):
        sd[f"noises.noise_{j}"] = _n(nz)
    return sd


def discriminator_state_dict_from_jax(cfg: DiscriminatorConfig, params) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    sd["convs.0.0.weight"] = _n(params["convs"][0]["weight"])
    sd["convs.0.1.bias"] = _n(params["convs"][0]["act_bias"])
    for b, block in enumerate(params["convs"][1:], start=1):
        sd[f"convs.{b}.conv1.0.weight"] = _n(block["conv1"]["weight"])
        sd[f"convs.{b}.conv1.1.bias"] = _n(block["conv1"]["act_bias"])
        sd[f"convs.{b}.conv2.1.weight"] = _n(block["conv2"]["weight"])
        sd[f"convs.{b}.conv2.2.bias"] = _n(block["conv2"]["act_bias"])
        sd[f"convs.{b}.skip.1.weight"] = _n(block["skip"]["weight"])
    sd["final_conv.0.weight"] = _n(params["final_conv"]["weight"])
    sd["final_conv.1.bias"] = _n(params["final_conv"]["act_bias"])
    for i, layer in enumerate(params["final_linear"]):
        sd[f"final_linear.{i}.weight"] = _n(layer["weight"])
        sd[f"final_linear.{i}.bias"] = _n(layer["bias"])
    return sd


def g_masks_from_jax(masks) -> Dict[str, np.ndarray]:
    """`rick_tpu` G masks {"convs": [{weight, mod_w, mod_b}]} -> {name: array}."""
    out = {}
    for i, m in enumerate(masks["convs"]):
        out[f"convs.{i}.conv.weight"] = _n(m["weight"])
        out[f"convs.{i}.conv.modulation.weight"] = _n(m["mod_w"])
        out[f"convs.{i}.conv.modulation.bias"] = _n(m["mod_b"])
    return out


_D_MASK_KEYS = {
    "conv1_w": "conv1.0.weight", "conv1_b": "conv1.1.bias", "conv2_w": "conv2.1.weight",
    "conv2_b": "conv2.2.bias", "skip_w": "skip.1.weight",
}


def d_masks_from_jax(masks) -> Dict[str, np.ndarray]:
    """`rick_tpu` D masks {"convs": [{conv1_w, ...}]} for ResBlocks 1.. ->
    {name: array}."""
    return {
        f"convs.{b}.{name}": _n(m[key])
        for b, m in enumerate(masks["convs"], start=1)
        for key, name in _D_MASK_KEYS.items()
    }


def _load_adam(opt: torch.optim.Adam, params, v_sd, count_sd) -> None:
    """`rick_tpu` Adam state -> torch's: v -> exp_avg_sq, count -> step.  A
    param whose count is 0 never stepped and keeps an empty state, as in
    torch.  exp_avg is the last gradient when beta1 = 0 and is overwritten at
    the next step, so it starts at zero."""
    for name, p in params.items():
        count = float(np.asarray(count_sd[name]).reshape(-1)[0])
        if count > 0:
            opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.as_tensor(v_sd[name]).to(p.device).reshape(p.shape).clone(),
            }


def train_state_from_jax(
    gcfg: GeneratorConfig, dcfg: DiscriminatorConfig, state_np, *, tcfg: TrainConfig, device="cuda",
) -> TrainState:
    """`rick_tpu`'s train state (the dict of `init_train_state`, its arrays
    as numpy) -> the port's `TrainState` on `device`: the four models, both
    Adam states, the four mask sets and the scalars."""
    rng = torch.Generator(device=device).manual_seed(0)  # overwritten below
    gsd = lambda tree: generator_state_dict_from_jax(gcfg, tree)  # noqa: E731
    dsd = lambda tree: discriminator_state_dict_from_jax(dcfg, tree)  # noqa: E731

    def load(module, sd):
        module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
        return module

    g = load(Generator(gcfg.size, gcfg.style_dim, gcfg.n_mlp, gcfg.channel_multiplier, gcfg.blur_kernel,
                       gcfg.lr_mlp, rng=rng, device=device), gsd(state_np["g"]))
    d = load(Discriminator(dcfg.size, dcfg.channel_multiplier, dcfg.blur_kernel, dcfg.stddev_group,
                           dcfg.stddev_feat, rng=rng, device=device), dsd(state_np["d"]))
    state = init_train_state(gcfg, dcfg, tcfg, rng=rng, device=device, g=g, d=d)
    load(state.g_ema, gsd(state_np["g_ema"]))
    load(state.d_ema, dsd(state_np["d_ema"]))
    _load_adam(state.g_opt, trainable_params(g, g_trainable),
               gsd(state_np["g_opt"]["v"]), gsd(state_np["g_opt"]["count"]))
    _load_adam(state.d_opt, trainable_params(d, d_trainable),
               dsd(state_np["d_opt"]["v"]), dsd(state_np["d_opt"]["count"]))

    def tensors(masks):
        return {k: torch.tensor(v, device=device) for k, v in masks.items()}

    state.g_freeze, state.g_prune = (tensors(g_masks_from_jax(state_np[k])) for k in ("g_freeze", "g_prune"))
    state.d_freeze, state.d_prune = (tensors(d_masks_from_jax(state_np[k])) for k in ("d_freeze", "d_prune"))
    for k in ("mean_path_length", "ada_p", "ada_stats", "r_t"):
        setattr(state, k, torch.tensor(_n(state_np[k]), device=device))
    return state


def merge_state_dict_lenient(module: nn.Module, loaded_sd: Dict) -> nn.Module:
    """`load_state_dict(strict=False)` plus a shape guard: keys the module
    lacks are ignored, keys the checkpoint lacks keep their values, and a key
    whose shape differs is skipped with a warning (torch would raise even
    with strict=False)."""
    own = module.state_dict()
    keep = {}
    for k, v in loaded_sd.items():
        if k not in own:
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(own[k].shape):
            warnings.warn(
                f"checkpoint key {k!r} has shape {tuple(v.shape)}, "
                f"model expects {tuple(own[k].shape)}; skipped"
            )
            continue
        keep[k] = v
    module.load_state_dict(keep, strict=False)
    return module


def load_checkpoint(
    path: str,
    device,
    *,
    g: Optional[nn.Module] = None,
    g_ema: Optional[nn.Module] = None,
    d: Optional[nn.Module] = None,
) -> Dict:
    """Read a rosinality checkpoint `{g, g_ema, d, g_optim, d_optim}` (also
    the files `rick_tpu.ckpt.save_torch_file` writes) onto `device`, merge
    its `g` / `g_ema` / `d` state dicts leniently into the modules given, and
    return the whole checkpoint."""
    ckpt = torch.load(path, map_location=device, weights_only=True)
    for name, module in (("g", g), ("g_ema", g_ema), ("d", d)):
        if module is not None:
            if name not in ckpt:
                raise KeyError(f"{path} has no {name!r} state dict")
            merge_state_dict_lenient(module, ckpt[name])
    return ckpt
