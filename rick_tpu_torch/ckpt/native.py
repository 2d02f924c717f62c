"""Full-state checkpoints in `rick_tpu`'s own format, so that a run resumes
across the two packages.  Port of `rick_tpu/ckpt/native.py`.

Format: one .npz whose keys are the '/'-joined paths of `rick_tpu`'s state
tree (dict keys, and list indices as digits: "g/convs/0/conv/weight"), with
the manifest (step and scalar metadata) embedded as `__manifest__` and
written beside it as a `.json` sidecar.  The tree is numpy: the port's
`TrainState` goes there through `ckpt.train_state_to_jax` and comes back
through `ckpt.train_state_from_jax`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'/'-joined path: array} of a nested dict/list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, list) else None
    if items is None:
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def unflatten(flat: Dict[str, np.ndarray]):
    """The inverse of `flatten`: a dict whose keys are 0..n-1 becomes a list."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


def save_state(path: str, tree, *, step: int, extra: Dict[str, Any] | None = None) -> None:
    """Atomic (tmp + rename): a kill mid-save never leaves a truncated .npz
    for --auto_resume.  The manifest is embedded in the npz, so a kill
    between the npz's rename and the sidecar's cannot leave a step-N npz
    that reads as step 0; the sidecar is for people."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    manifest = {"step": step, **(extra or {})}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: np.savez would append .npz to a name
        np.savez(f, __manifest__=np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8), **flatten(tree))
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(path + ".json.tmp", path + ".json")


def load_state(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(state tree, manifest).  The manifest is the embedded one, else the
    sidecar; a step still missing is read from a `{step:06d}.state.npz`
    name, as `rick_tpu` does."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != "__manifest__"}
        manifest = json.loads(bytes(data["__manifest__"]).decode()) if "__manifest__" in data.files else {}
    if not manifest and os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
    if "step" not in manifest:
        base = os.path.basename(path)
        if base.endswith(".state.npz") and base[:-10].isdigit():
            manifest["step"] = int(base[:-10])
    return unflatten(flat), manifest
