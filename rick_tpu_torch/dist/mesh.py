"""Data-parallel helpers over a process group.  Port of
`rick_tpu/dist/mesh.py`.

`rick_tpu` shards the global batch along a 1-D `data` mesh and replicates
params and state, and XLA derives the collectives from the global-batch
math.  Here every rank is a process with its own copy of the state: the
global batch is cut into equal row blocks, one per rank in rank order
(`local_rows`), and `replicate` broadcasts rank 0's tensors once (at the
start, after a resume), after which the ranks keep them equal by taking the
same steps from all-reduced gradients (`train/steps.py`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from rick_tpu_torch.dist.multihost import Group, _all_reduce_, _broadcast_, process_batch_slice, world_size


def local_batch_size(global_batch: int, group: Group) -> int:
    """Rows per rank of a global batch; a batch that does not divide raises."""
    return process_batch_slice(global_batch, group)[1]


def local_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's rows of a global batch (dim 0)."""
    start, size = process_batch_slice(x.shape[0], group)
    return x if group is None else x[start : start + size]


def _flat_groups(tensors: Iterable[torch.Tensor]) -> Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]]:
    out: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def _apply_flat(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run `collective(flat)` in place on one flat buffer per (dtype,
    device) of `tensors`, and copy the result back into them."""
    for ts in _flat_groups(tensors).values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        collective(flat)
        with torch.no_grad():
            for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(piece.view_as(t))


def replicate(tensors: Iterable[torch.Tensor], group: Group, src: int = 0) -> None:
    """In place: rank `src`'s values of `tensors` on every rank (the same
    list, in the same order, on each)."""
    if group is not None:
        _apply_flat(list(tensors), lambda flat: _broadcast_(flat, group, src))


def average_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """In place: the mean over the ranks of each tensor, through one
    all-reduce per (dtype, device)."""
    if group is not None:
        n = world_size(group)
        _apply_flat(list(tensors), lambda flat: _all_reduce_(flat, group).div_(n))


def sum_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """In place: the sum over the ranks of each tensor, through one
    all-reduce per (dtype, device)."""
    if group is not None:
        _apply_flat(list(tensors), lambda flat: _all_reduce_(flat, group))
