"""Data-parallel runs over `torch.distributed`: one process per card,
started by torchrun.  Port of `rick_tpu/dist` (its mesh becomes a process
group)."""

from rick_tpu_torch.dist.mesh import average_, local_batch_size, local_rows, replicate, sum_
from rick_tpu_torch.dist.multihost import (
    Group,
    all_gather_rows,
    initialize_multihost,
    is_main_process,
    launched_world_size,
    process_batch_slice,
    rank,
    reduce_mean,
    reduce_sum,
    world_size,
)

__all__ = [
    "Group",
    "all_gather_rows",
    "average_",
    "initialize_multihost",
    "is_main_process",
    "launched_world_size",
    "local_batch_size",
    "local_rows",
    "process_batch_slice",
    "rank",
    "reduce_mean",
    "reduce_sum",
    "replicate",
    "sum_",
    "world_size",
]
