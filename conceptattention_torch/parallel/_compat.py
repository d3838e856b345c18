"""The per-rank runner under the JAX package's name for it.

`shard_map_compat(fn, mesh, in_specs, out_specs)` is
`parallel.collectives.shard_map`: `fn(rank, *shards)` once for each rank of
the mesh, generator bodies stepped in lock step with the collectives they
yield.
"""

from conceptattention_torch.parallel.collectives import shard_map as shard_map_compat

__all__ = ["shard_map_compat"]
