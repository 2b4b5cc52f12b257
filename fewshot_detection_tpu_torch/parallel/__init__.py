from .mesh import (
    Mesh, make_mesh, batch_sharding, replicated_sharding, shard_batch, replicate,
)

__all__ = [
    "Mesh", "make_mesh", "batch_sharding", "replicated_sharding", "shard_batch",
    "replicate",
]
