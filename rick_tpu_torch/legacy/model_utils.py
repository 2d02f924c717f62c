"""Model bookkeeping helpers (`gan_training/utils.py`,
`gan_training/utils_model_load.py`).  Port of
`rick_tpu/legacy/model_utils.py`."""

from __future__ import annotations

import numpy as np
import torch

from rick_tpu_torch.utils.images import save_image_grid


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def get_parameter_number(params, name: str = "model"):
    """Parameter counts (`utils_model_load.py:10-14`) of an `nn.Module`
    (Trainable: those that require grad) or of a tree of tensors or arrays
    (every leaf counts as trainable, as in rick_tpu)."""
    if isinstance(params, torch.nn.Module):
        total = sum(p.numel() for p in params.parameters())
        trainable = sum(p.numel() for p in params.parameters() if p.requires_grad)
        return {"name": name, "Total": total, "Trainable": trainable}
    total = sum(int(np.prod(x.shape)) for x in _leaves(params))
    return {"name": name, "Total": total, "Trainable": total}


def save_feature_map(feats, outfile: str, nrow: int = 8):
    """Grid of the N * C feature maps of feats (N, C, H, W), each min-max
    normalized (`gan_training/utils.py:12-21`)."""
    arr = feats.detach().float().cpu().numpy() if isinstance(feats, torch.Tensor) else np.asarray(feats, np.float32)
    n, c, h, w = arr.shape
    flat = arr.reshape(n * c, -1)
    vmin = flat.min(axis=1, keepdims=True)
    vmax = flat.max(axis=1, keepdims=True)
    norm = (flat - vmin) / np.maximum(vmax - vmin, 1e-12)
    maps = norm.reshape(n * c, 1, h, w)
    # three channels in [0, 1], mapped into [-1, 1] for the saver
    rgb = np.repeat(maps, 3, axis=1) * 2.0 - 1.0
    save_image_grid(torch.from_numpy(rgb), outfile, nrow=nrow)


@torch.no_grad()
def update_average(tgt, src, beta: float):
    """EMA update (`gan_training/utils.py:52-58`): beta * tgt + (1 - beta) *
    src.  Two `nn.Module`s: tgt's parameters in place, tgt returned.  Two
    trees of tensors: a new tree."""
    if isinstance(tgt, torch.nn.Module):
        src_params = dict(src.named_parameters())
        for k, p in tgt.named_parameters():
            p.copy_(beta * p + (1.0 - beta) * src_params[k])
        return tgt
    if isinstance(tgt, dict):
        return {k: update_average(v, src[k], beta) for k, v in tgt.items()}
    if isinstance(tgt, (list, tuple)):
        return type(tgt)(update_average(a, b, beta) for a, b in zip(tgt, src))
    return beta * tgt + (1.0 - beta) * src
