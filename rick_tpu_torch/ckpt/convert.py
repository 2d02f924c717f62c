"""rick_tpu parameter pytrees and train states <-> the port's state dicts and
`TrainState` (and Inception params -> the port's `InceptionV3`), rosinality
`.pt` checkpoint loading, and the reference's 5-key `.pt` layout with its
torch Adam states.  Port of `rick_tpu/ckpt/convert.py`.

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

StyleGAN3-T's `Generator3` keeps NVlabs' keys; `generator3_state_dict_from_nvlabs`
takes an NVlabs G_ema state dict and drops what the port computes.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from rick_tpu_torch.nn.discriminator import Discriminator, DiscriminatorConfig
from rick_tpu_torch.nn.generator import Generator, GeneratorConfig
from rick_tpu_torch.nn.stylegan3 import Generator3
from rick_tpu_torch.train.adam import exp_avg_sq, step_counts
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


def inception_state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """`rick_tpu`'s flat Inception params -> f32 numpy arrays under the same
    keys: both packages use torchvision's, so the dict goes as it is to
    `inception_from_params`, which keeps the keys of the port's module."""
    return {k: _n(v) for k, v in params.items()}


def vgg16_state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """`rick_tpu`'s VGG16 params -> f32 numpy arrays under the same keys,
    torchvision's, which `metrics.vgg16_from_params` takes; the keys and
    shapes must be config D's up to fc2."""
    from rick_tpu_torch.metrics.vgg import PARAM_SHAPES  # imported here: the ckpt package does not load metrics

    sd = {k: _n(v) for k, v in params.items()}
    if set(sd) != set(PARAM_SHAPES):
        raise KeyError(f"VGG16 params: missing {sorted(set(PARAM_SHAPES) - set(sd))}, "
                       f"unexpected {sorted(set(sd) - set(PARAM_SHAPES))}")
    bad = {k: v.shape for k, v in sd.items() if v.shape != PARAM_SHAPES[k]}
    if bad:
        raise ValueError(f"VGG16 params of the wrong shape: {bad}")
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


# ---------------------------------------------------------------------------
# the port's train state -> rick_tpu's state tree and the reference's .pt
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A host f32 numpy array of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _styled_from_sd(sd, prefix: str):
    return {
        "conv": {
            "weight": _host(sd[f"{prefix}.conv.weight"])[0],  # (1, o, i, k, k) -> (o, i, k, k)
            "modulation": {
                "weight": _host(sd[f"{prefix}.conv.modulation.weight"]),
                "bias": _host(sd[f"{prefix}.conv.modulation.bias"]),
            },
        },
        "noise_weight": _host(sd[f"{prefix}.noise.weight"]).reshape(()),
        "act_bias": _host(sd[f"{prefix}.activate.bias"]),
    }


def _torgb_from_sd(sd, prefix: str):
    return {
        "conv": {
            "weight": _host(sd[f"{prefix}.conv.weight"])[0],
            "modulation": {
                "weight": _host(sd[f"{prefix}.conv.modulation.weight"]),
                "bias": _host(sd[f"{prefix}.conv.modulation.bias"]),
            },
        },
        "bias": _host(sd[f"{prefix}.bias"]),
    }


def generator_params_from_state_dict(cfg: GeneratorConfig, sd) -> Dict[str, Any]:
    """A rosinality G state dict -> `rick_tpu`'s G params as numpy (the
    inverse of `generator_state_dict_from_jax`; numpy copy of `rick_tpu`'s)."""
    return {
        "style": [{"weight": _host(sd[f"style.{i + 1}.weight"]), "bias": _host(sd[f"style.{i + 1}.bias"])}
                  for i in range(cfg.n_mlp)],
        "input": _host(sd["input.input"]),
        "conv1": _styled_from_sd(sd, "conv1"),
        "to_rgb1": _torgb_from_sd(sd, "to_rgb1"),
        "convs": [_styled_from_sd(sd, f"convs.{i}") for i in range(2 * (cfg.log_size - 2))],
        "to_rgbs": [_torgb_from_sd(sd, f"to_rgbs.{i}") for i in range(cfg.log_size - 2)],
        "noises": [_host(sd[f"noises.noise_{j}"]) for j in range(cfg.num_layers)],
    }


def discriminator_params_from_state_dict(cfg: DiscriminatorConfig, sd) -> Dict[str, Any]:
    """A rosinality D state dict -> `rick_tpu`'s D params as numpy (numpy
    copy of `rick_tpu`'s)."""
    def conv(w, b):
        return {"weight": _host(sd[w]), "act_bias": _host(sd[b])}

    convs = [conv("convs.0.0.weight", "convs.0.1.bias")]
    for b in range(1, cfg.log_size - 1):
        convs.append({
            "conv1": conv(f"convs.{b}.conv1.0.weight", f"convs.{b}.conv1.1.bias"),
            "conv2": conv(f"convs.{b}.conv2.1.weight", f"convs.{b}.conv2.2.bias"),
            "skip": {"weight": _host(sd[f"convs.{b}.skip.1.weight"])},
        })
    return {
        "convs": convs,
        "final_conv": conv("final_conv.0.weight", "final_conv.1.bias"),
        "final_linear": [{"weight": _host(sd[f"final_linear.{i}.weight"]), "bias": _host(sd[f"final_linear.{i}.bias"])}
                         for i in range(2)],
    }


def g_masks_to_jax(masks) -> Dict[str, Any]:
    """{name: mask} -> `rick_tpu`'s G masks {"convs": [{weight, mod_w, mod_b}]}."""
    n = sum(1 for k in masks if k.endswith(".conv.weight"))
    return {"convs": [{"weight": _host(masks[f"convs.{i}.conv.weight"]),
                       "mod_w": _host(masks[f"convs.{i}.conv.modulation.weight"]),
                       "mod_b": _host(masks[f"convs.{i}.conv.modulation.bias"])} for i in range(n)]}


def d_masks_to_jax(masks) -> Dict[str, Any]:
    """{name: mask} -> `rick_tpu`'s D masks, a list over ResBlocks 1.."""
    n = sum(1 for k in masks if k.endswith(".skip.1.weight"))
    return {"convs": [{key: _host(masks[f"convs.{b}.{name}"]) for key, name in _D_MASK_KEYS.items()}
                      for b in range(1, n + 1)]}


def state_dicts(state: TrainState) -> Dict[str, Any]:
    """The port's train state as named tensors, in `rick_tpu`'s top-level
    layout: the four models' state dicts; per optimizer `v` (exp_avg_sq)
    and `count` (step, an int) of each trainable param, zeros and 0 for
    those that never stepped; the four mask sets; the scalars.  The tensors
    are the live ones (no copy); `ckpt.async_io.snapshot` copies them."""
    def opt(o, module, trainable):
        params = trainable_params(module, trainable)
        return {"v": exp_avg_sq(o, params), "count": step_counts(o, params)}

    return {
        "g": state.g.state_dict(), "d": state.d.state_dict(),
        "g_ema": state.g_ema.state_dict(), "d_ema": state.d_ema.state_dict(),
        "g_opt": opt(state.g_opt, state.g, g_trainable), "d_opt": opt(state.d_opt, state.d, d_trainable),
        "g_freeze": dict(state.g_freeze), "g_prune": dict(state.g_prune),
        "d_freeze": dict(state.d_freeze), "d_prune": dict(state.d_prune),
        **{k: getattr(state, k) for k in ("mean_path_length", "ada_p", "ada_stats", "r_t")},
    }


def _first_leaves(tree):
    """Each leaf -> a 0-d f32 array of its first element."""
    if isinstance(tree, dict):
        return {k: _first_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_first_leaves(v) for v in tree]
    return np.array(tree.flat[0], np.float32)


def _adam_tree(params_from_sd, cfg, model_sd, opt) -> Dict[str, Any]:
    """`rick_tpu`'s Adam state {v, count} over every leaf of a model: the
    trainable params' v and step counts, zeros for the rest (`adam_init`)."""
    v_sd = {k: opt["v"][k] if k in opt["v"] else np.zeros(tuple(t.shape), np.float32) for k, t in model_sd.items()}
    c_sd = {k: np.broadcast_to(np.float32(opt["count"].get(k, 0)), tuple(t.shape)) for k, t in model_sd.items()}
    return {"v": params_from_sd(cfg, v_sd), "count": _first_leaves(params_from_sd(cfg, c_sd))}


def train_state_to_jax(state, gcfg: GeneratorConfig = None, dcfg: DiscriminatorConfig = None) -> Dict[str, Any]:
    """The port's `TrainState` (or its `state_dicts`, e.g. a host snapshot)
    -> `rick_tpu`'s train state tree as numpy, every leaf
    `rick_tpu.train.init_train_state` has; the inverse of
    `train_state_from_jax`.  `gcfg` / `dcfg` default to the models'."""
    if isinstance(state, TrainState):
        gcfg, dcfg = gcfg or state.g.cfg, dcfg or state.d.cfg
        state = state_dicts(state)
    g = lambda sd: generator_params_from_state_dict(gcfg, sd)  # noqa: E731
    d = lambda sd: discriminator_params_from_state_dict(dcfg, sd)  # noqa: E731
    return {
        "g": g(state["g"]), "d": d(state["d"]), "g_ema": g(state["g_ema"]), "d_ema": d(state["d_ema"]),
        "g_opt": _adam_tree(generator_params_from_state_dict, gcfg, state["g"], state["g_opt"]),
        "d_opt": _adam_tree(discriminator_params_from_state_dict, dcfg, state["d"], state["d_opt"]),
        "g_freeze": g_masks_to_jax(state["g_freeze"]), "g_prune": g_masks_to_jax(state["g_prune"]),
        "d_freeze": d_masks_to_jax(state["d_freeze"]), "d_prune": d_masks_to_jax(state["d_prune"]),
        **{k: _host(state[k]) for k in ("mean_path_length", "ada_p", "ada_stats", "r_t")},
    }


def _adam_state_dict(opt, *, lr: float, betas) -> Dict[str, Any]:
    """torch.optim.Adam.state_dict() layout (torch 1.12's defaults), as
    `rick_tpu` writes it: one entry per trainable param in the optimizer's
    order, `step` an int (0 for a param that never stepped), `exp_avg_sq`
    its second moment and `exp_avg` zeros.  beta1 = 0, so the first moment
    is overwritten by the next step (exp_avg = grad) and zeros resume
    exactly."""
    state = {}
    for i, name in enumerate(opt["v"]):
        v = opt["v"][name].detach().cpu()
        state[i] = {"step": int(opt["count"][name]), "exp_avg": torch.zeros_like(v), "exp_avg_sq": v}
    return {
        "state": state,
        "param_groups": [{
            "lr": float(lr), "betas": (float(betas[0]), float(betas[1])), "eps": 1e-08, "weight_decay": 0,
            "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
            "params": list(range(len(state))),
        }],
    }


def g_optim_state_dict(g_opt, *, lr: float, betas) -> Dict[str, Any]:
    """The reference's g_optim state dict from `state_dicts(state)["g_opt"]`:
    params are G's named_parameters with `convs.` (per StyledConv
    conv.weight, conv.modulation.weight/.bias, noise.weight, activate.bias)."""
    return _adam_state_dict(g_opt, lr=lr, betas=betas)


def d_optim_state_dict(d_opt, *, lr: float, betas) -> Dict[str, Any]:
    """The reference's d_optim state dict from `state_dicts(state)["d_opt"]`:
    D's ResBlocks 1.. (conv1.0.weight, conv1.1.bias, conv2.1.weight,
    conv2.2.bias, skip.1.weight), then final_conv and final_linear."""
    return _adam_state_dict(d_opt, lr=lr, betas=betas)


def torch_checkpoint(state, tcfg: TrainConfig) -> Dict[str, Any]:
    """The reference's 5-key checkpoint {g_ema, g, d, g_optim, d_optim}
    (`train_dynamic_update_prune.py:644-659`) of a `TrainState` or its
    `state_dicts`, as host tensors for `torch.save`."""
    if isinstance(state, TrainState):
        state = state_dicts(state)
    host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    return {
        "g_ema": host(state["g_ema"]), "g": host(state["g"]), "d": host(state["d"]),
        "g_optim": g_optim_state_dict(state["g_opt"], lr=tcfg.g_lr, betas=(0.0, tcfg.g_beta2)),
        "d_optim": d_optim_state_dict(state["d_opt"], lr=tcfg.d_lr, betas=(0.0, tcfg.d_beta2)),
    }


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


# what NVlabs' G_ema holds and the port's Generator3 computes in its constructor
NVLABS_COMPUTED = ("up_filter", "down_filter", "transform")


def generator3_state_dict_from_nvlabs(g: Generator3, sd: Dict) -> Dict[str, torch.Tensor]:
    """The state dict of `g` from NVlabs' `networks_stylegan3.Generator`
    state dict (G_ema, the same keys): each layer's `up_filter` and
    `down_filter` and the input's `transform` are checked against the ones
    `g` computed, to 1e-6 of the largest value (the same float64 design,
    rounded to f32 twice), and dropped; a mismatch or a filter `g` does not
    have raises ValueError."""
    computed = dict(g.named_buffers())
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v)
        if k.rsplit(".", 1)[-1] not in NVLABS_COMPUTED:
            out[k] = v
            continue
        mine = computed.get(k)
        if mine is None or tuple(mine.shape) != tuple(v.shape):
            raise ValueError(f"{k} {tuple(v.shape)}: the port's Generator3 has "
                             f"{'no such buffer' if mine is None else tuple(mine.shape)}")
        mine = mine.detach().cpu().double()
        if float((v.detach().cpu().double() - mine).abs().max()) > 1e-6 * float(mine.abs().max()):
            raise ValueError(f"{k} differs from the one the port's Generator3 computes")
    return out
