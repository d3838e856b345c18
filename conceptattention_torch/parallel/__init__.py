"""Sequence parallelism: the `seq` device mesh and ring attention.

Counterpart of the JAX package's `parallel/` for the one composition the
port runs: a mesh whose only axis above 1 is `seq`, over which the fused
attention sequence is split into a ring (`ring_attention.py`; its hand-written
CUDA form is `kernels/ring_rdma.py`). Data, tensor, pipeline and expert
parallelism are not ported yet.
"""

from conceptattention_torch.parallel.mesh import AXES, Mesh, MeshAxes, make_mesh

__all__ = ["AXES", "Mesh", "MeshAxes", "make_mesh"]
