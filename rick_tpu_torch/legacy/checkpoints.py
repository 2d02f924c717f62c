"""CheckpointIO: save and load registered objects
(`gan_training/checkpoints.py:8-97`).  Port of
`rick_tpu/legacy/checkpoints.py`, over the port's `ckpt/native.py`: the same
.npz format, so either package loads what the other saved.

A registered object is a tree (dicts and lists) of tensors or arrays, or
anything with `state_dict` / `load_state_dict` (an `nn.Module`, an
optimizer), whose state dict is saved.  Loading from a URL raises: there is
no network."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from rick_tpu_torch.ckpt.native import load_state, save_state


def _to_numpy(tree):
    if hasattr(tree, "state_dict"):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return {str(k): _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


class CheckpointIO:
    def __init__(self, checkpoint_dir: str = "./chkpts"):
        self.module_dict: Dict[str, Any] = {}
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **kwargs):
        self.module_dict.update(kwargs)

    def _path(self, filename: str) -> str:
        return filename if os.path.isabs(filename) else os.path.join(self.checkpoint_dir, filename)

    def save(self, filename: str, **scalars):
        """Every registered object, with `it` as the step and the other
        scalars in the manifest."""
        tree = {k: _to_numpy(v) for k, v in self.module_dict.items()}
        save_state(self._path(filename), tree, step=int(scalars.pop("it", 0)), extra=scalars)

    def load(self, filename: str) -> Dict[str, Any]:
        """Restore the registered names found in the file; returns the
        manifest.  An object with `load_state_dict` is loaded in place;
        any other is replaced by the file's tree as CPU tensors."""
        if filename.startswith("http"):
            raise IOError("URL checkpoint loading is unavailable (no network)")
        state, manifest = load_state(self._path(filename))
        for name, tree in state.items():
            current = self.module_dict.get(name)
            if hasattr(current, "load_state_dict"):
                current.load_state_dict(_to_torch(tree))
            else:
                self.module_dict[name] = _to_torch(tree)
        return manifest
