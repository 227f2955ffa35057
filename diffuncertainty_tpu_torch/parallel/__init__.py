"""The (data, member) layout over ``torch.distributed`` (``mesh``) and the
process group of a multi-process run (``distributed``)."""

from .distributed import (
    global_batch,
    initialize_distributed,
    is_primary,
    loader_shard,
    process_info,
)
from .mesh import batch_sharding, make_mesh, replicated_sharding

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "initialize_distributed",
    "process_info",
    "loader_shard",
    "global_batch",
    "is_primary",
]
