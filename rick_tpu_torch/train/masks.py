"""Freeze / prune masks and their application.  Port of `rick_tpu/train/masks.py`.

A mask set is a dict {state-dict name: 1-D float tensor} with 1.0 on the
selected filters, over exactly the maskable params of `rick_tpu`:

  G  convs.{i}.conv.weight                  (1, out, in, k, k) -> out-filter axis (dim 1)
     convs.{i}.conv.modulation.weight/bias  (in, style) / (in,) -> in-channel axis (dim 0)
  D  convs.{b}.conv1.0.weight, .conv1.1.bias, .conv2.1.weight, .conv2.2.bias,
     .skip.1.weight (b >= 1)                 -> out-filter axis (dim 0)

Because masks are keyed by name, one function serves G and D for each
operation.  The trainable sets are name predicates: G trains `convs.*`; D
trains `convs.*` but `convs.0`, plus `final_conv.*` and `final_linear.*`, and
during warmup only the latter two.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

Masks = Dict[str, torch.Tensor]


def init_g_masks(g: nn.Module) -> Masks:
    """Zero masks over G's maskable filters."""
    masks = {}
    for i, blk in enumerate(g.convs):
        _, out_ch, in_ch = blk.conv.weight.shape[:3]
        dev = blk.conv.weight.device
        masks[f"convs.{i}.conv.weight"] = torch.zeros(out_ch, device=dev)
        masks[f"convs.{i}.conv.modulation.weight"] = torch.zeros(in_ch, device=dev)
        masks[f"convs.{i}.conv.modulation.bias"] = torch.zeros(in_ch, device=dev)
    return masks


def init_d_masks(d: nn.Module) -> Masks:
    """Zero masks over D's maskable filters (ResBlocks 1..)."""
    masks = {}
    for b in range(1, len(d.convs)):
        params = dict(d.convs[b].named_parameters())
        for name in ("conv1.0.weight", "conv1.1.bias", "conv2.1.weight", "conv2.2.bias", "skip.1.weight"):
            p = params[name]
            masks[f"convs.{b}.{name}"] = torch.zeros(p.shape[0], device=p.device)
    return masks


def _keep(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1 - mask, broadcast along the filter axis of x: dim 1 of the 5-D
    modulated conv weight, dim 0 otherwise."""
    shape = [1] * x.ndim
    shape[1 if x.ndim == 5 else 0] = -1
    return (1.0 - mask).reshape(shape)


def mask_grads(grads: Mapping[str, torch.Tensor], freeze: Masks, prune: Masks) -> Dict[str, torch.Tensor]:
    """Zero the gradients of frozen or pruned filters: kill = max(freeze,
    prune).  Names without a mask, or without a gradient, pass unchanged."""
    out = dict(grads)
    for name, f in freeze.items():
        if name in out:
            out[name] = out[name] * _keep(torch.maximum(f, prune[name]), out[name])
    return out


@torch.no_grad()
def prune_params(module: nn.Module, prune: Masks) -> None:
    """Zero the pruned filters of `module` in place."""
    params = dict(module.named_parameters())
    for name, m in prune.items():
        params[name].mul_(_keep(m, params[name]))


def merge_prune(old: Masks, new: Masks) -> Masks:
    """Monotonic accumulation of prune masks: elementwise OR."""
    return {k: torch.maximum(old[k], new[k]) for k in old}


def g_trainable(name: str) -> bool:
    return name.startswith("convs.")


def d_final(name: str) -> bool:
    """The warmup-trainable D params."""
    return name.startswith(("final_conv.", "final_linear."))


def d_trainable(name: str) -> bool:
    return d_final(name) or (name.startswith("convs.") and not name.startswith("convs.0."))
