"""Parallelism over a (data, pipe, expert, seq, model) device mesh.

Counterpart of the JAX package's `parallel/`. One process runs every rank
of a mesh (`collectives.py`: collectives over lists of shards, the per-rank
runner `shard_map`, `Sharded` tensors); on top of it tensor parallelism
(`sharding.py`, run by the Flux blocks), FSDP (`fsdp.py`, run by the
training step), the sequence ring (`ring_attention.py`; its CUDA form is
`kernels/ring_rdma.py`), GPipe (`pipeline.py`) and expert-parallel MoE
(`moe.py`).
"""

from conceptattention_torch.parallel.collectives import NamedSharding, P, Sharded, shard_map
from conceptattention_torch.parallel.fsdp import (
    flux_fsdp_sharding,
    fsdp_sharding,
    fsdp_spec,
    shard_params_fsdp,
)
from conceptattention_torch.parallel.mesh import AXES, Mesh, MeshAxes, make_mesh
from conceptattention_torch.parallel.moe import init_moe_params, moe_mlp, moe_mlp_expert_parallel
from conceptattention_torch.parallel.pipeline import pipeline_apply
from conceptattention_torch.parallel.sharding import (
    activation_sharding,
    flux_param_sharding,
    shard_params,
)

__all__ = [
    "make_mesh",
    "MeshAxes",
    "flux_param_sharding",
    "shard_params",
    "activation_sharding",
    "flux_fsdp_sharding",
    "fsdp_sharding",
    "fsdp_spec",
    "shard_params_fsdp",
    "pipeline_apply",
    "init_moe_params",
    "moe_mlp",
    "moe_mlp_expert_parallel",
    "AXES",
    "Mesh",
    "NamedSharding",
    "P",
    "Sharded",
    "shard_map",
]
