"""Multi-process runtime over `torch.distributed`.  Port of
`rick_tpu/dist/multihost.py`.

`rick_tpu` runs one process per host, which drives that host's devices
through one mesh; here each process drives one card, as `torchrun` starts
them: `torchrun --nproc_per_node N -m rick_tpu_torch.cli.train ...` sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR` and
`MASTER_PORT`, and `initialize_multihost` joins the process group they
describe.  A process started without `WORLD_SIZE` creates no group and runs
alone.

Every function here takes the process group explicitly; `group=None` is the
single process, for which each collective is the identity.  A gloo group
takes CUDA tensors as they are (all_reduce, broadcast and all_gather of CUDA
tensors run over gloo with torch 2.11 on the H100), which is how two ranks
share one card: NCCL refuses that ("Duplicate GPU detected").  `all_gather_rows`
is differentiable twice (R1 differentiates D's input gradient, which passes
through the minibatch-stddev gather).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def launched_world_size() -> Optional[int]:
    """The world size torchrun's `WORLD_SIZE` announces; None in a process
    that no launcher started."""
    world = os.environ.get("WORLD_SIZE")
    return None if world is None else int(world)


def initialize_multihost(device="cuda", *, backend: Optional[str] = None) -> Tuple[Group, torch.device]:
    """Join the process group torchrun's variables describe; returns (group,
    this rank's device).  Without `WORLD_SIZE` in the environment: (None,
    `device`), no group.

    The backend is NCCL for CUDA and gloo for the CPU.  On CUDA, rank r runs
    on `cuda:LOCAL_RANK`; more local ranks than cards raise, unless the
    caller asks for gloo explicitly (NCCL refuses two ranks on one card),
    and then local rank r takes card r modulo the count."""
    device = torch.device(device)
    world = launched_world_size()
    if world is None:
        return None, device
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    asked = backend
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if local_world > cards and asked != "gloo":
            raise RuntimeError(f"{local_world} local ranks but {cards} CUDA device(s): one rank per card, or ask "
                               "for backend='gloo' explicitly")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"a {dist.get_backend()} process group exists; asked for {backend}")
    return dist.group.WORLD, device


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def is_main_process(group: Group = None) -> bool:
    """The rank-0 guard for files, logs and grids (the reference's
    `get_rank() == 0`)."""
    return rank(group) == 0


def process_batch_slice(global_batch: int, group: Group) -> Tuple[int, int]:
    """(start, size) of this rank's rows of a global batch."""
    n = world_size(group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return rank(group) * per, per


def _all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """In-place sum over the ranks; returns `t`."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _broadcast_(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """In place: rank `src`'s values on every rank; returns `t`."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def _all_gather(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's `t` (equal shapes), in rank order."""
    if group is None:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the ranks, as a new tensor (not differentiable)."""
    return _all_reduce_(x.detach().clone(), group)


def reduce_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Mean over the ranks, as a new tensor (not differentiable)."""
    return reduce_sum(x, group) / world_size(group)


class _GatherRows(torch.autograd.Function):
    """y = cat over ranks of x.  Its adjoint is `_SumLocalRows`: each rank's
    cotangent of the global tensor is summed over the ranks, and a rank keeps
    its rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(_all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        return _SumLocalRows.apply(g, ctx.group), None


class _SumLocalRows(torch.autograd.Function):
    """y = this rank's rows of the sum over ranks of g.  Its adjoint is
    `_GatherRows`."""

    @staticmethod
    def forward(ctx, g, group):
        ctx.group = group
        total = _all_reduce_(g.detach().contiguous().clone(), group)
        start, size = process_batch_slice(total.shape[0], group)
        return total[start : start + size].clone()

    @staticmethod
    def backward(ctx, h):
        return _GatherRows.apply(h, ctx.group), None


def all_gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The global batch from each rank's rows (equal row counts), in rank
    order, differentiable twice: the gradient of a rank's rows is the sum
    over the ranks of their cotangents of the global tensor, so that an
    all-reduce-mean of the parameter gradients afterwards gives the gradient
    of the global loss."""
    return x if group is None else _GatherRows.apply(x, group)
