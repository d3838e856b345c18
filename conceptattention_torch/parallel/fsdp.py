"""FSDP (ZeRO-3-style fully-sharded data parallelism) for training.

Counterpart of the JAX package's `parallel/fsdp.py`. Parameters, and so
the optimizer state made from them, are sharded over the *data* mesh axis
along a weight dimension that tensor parallelism leaves free; the batch
splits over the same axis. Where XLA inserts the collectives from the
specs, the port runs them itself (`models/flux/dit.py`):

  - forward: each block gathers ONE layer's shards of its data slice just
    in time, inside the block's rematerialization, so peak weight memory is
    the shards plus one layer;
  - backward: the gather's backward returns each data rank's gradient to
    the shard it came from, and autograd sums the ranks' contributions
    there: the reduce-scatter;
  - optimizer: AdamW over the shards (`training/train_step.py`), so its
    moments are sharded the same way (ZeRO).

`fsdp_spec` derives the layout for any param tree: per leaf, the largest
dimension the fsdp axis divides that an existing tensor-parallel spec does
not already shard, so FSDP composes with the Megatron rules of
`parallel/sharding.py` on a (data, model) mesh. Quantized (serving) trees
are refused: train LoRA adapters against them instead (`training/lora.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from conceptattention_torch.ops.quant import _is_quantized
from conceptattention_torch.parallel.collectives import NamedSharding, P, Sharded
from conceptattention_torch.parallel.mesh import AXES, Mesh
from conceptattention_torch.parallel.sharding import spec_map


def _leaf_fsdp_spec(shape, base: P, n: int, axis_name: str, min_size: int) -> P:
    """Extend `base` (a possibly-shorter TP spec) with `axis_name` on the
    largest dimension it divides and TP does not already occupy."""
    parts = list(base) + [None] * (len(shape) - len(base))
    if n <= 1:
        return base
    size = 1
    for d in shape:
        size *= d
    if size < min_size:
        return base
    best = None
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is not None:
            continue
        if dim % n == 0 and dim >= n and (best is None or dim > shape[best]):
            best = i
    if best is None:
        return base
    parts[best] = axis_name
    return P(*parts)


def _leaf_shape(p):
    return tuple(p.shape)


def fsdp_spec(
    params: Dict[str, Any],
    mesh: Mesh,
    base_spec: Optional[Dict[str, Any]] = None,
    axis: str = AXES.data,
    min_size: int = 0,
) -> Dict[str, Any]:
    """P tree sharding every (divisible) param leaf over `axis`.

    base_spec: an existing spec tree (e.g. parallel.sharding.flux_param_spec)
      whose entries are respected: FSDP picks a dimension TP left unsharded,
      so the result composes both strategies. None means pure FSDP.
    min_size: leaves with fewer elements stay at their base spec (0 shards
      everything divisible).
    """
    n = mesh.shape[axis]

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s.get(k, P()) if isinstance(s, dict) else P()) for k in p}
        return _leaf_fsdp_spec(_leaf_shape(p), s if isinstance(s, P) else P(), n, axis, min_size)

    return walk(params, base_spec if base_spec is not None else P())


def fsdp_sharding(
    params: Dict[str, Any],
    mesh: Mesh,
    base_spec: Optional[Dict[str, Any]] = None,
    axis: str = AXES.data,
    min_size: int = 0,
) -> Dict[str, Any]:
    """NamedSharding tree for `fsdp_spec` (make_train_step's
    `param_sharding`)."""
    return spec_map(lambda s: NamedSharding(mesh, s),
                    fsdp_spec(params, mesh, base_spec=base_spec, axis=axis, min_size=min_size))


def flux_fsdp_sharding(
    params: Dict[str, Any],
    mesh: Mesh,
    cfg=None,
    tensor_parallel: bool = True,
    min_size: int = 0,
) -> Dict[str, Any]:
    """Flux convenience: FSDP over `data` composed (by default) with the
    Megatron TP rules over `model`."""
    base = None
    if tensor_parallel and mesh.shape.get(AXES.model, 1) > 1:
        from conceptattention_torch.parallel.sharding import flux_param_spec

        base = flux_param_spec(cfg)
    return fsdp_sharding(params, mesh, base_spec=base, min_size=min_size)


def _quantized_paths(tree, path=""):
    if _is_quantized(tree):
        return [path or "<root>"]
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _quantized_paths(v, f"{path}['{k}']")]
    return []


def shard_params_fsdp(
    params: Dict[str, Any],
    mesh: Mesh,
    cfg=None,
    tensor_parallel: bool = True,
    min_size: int = 0,
) -> Dict[str, Any]:
    """Place a float param tree onto the mesh fully sharded (ZeRO-3): each
    leaf a `Sharded` whose pieces are their own tensors (copies), ready to
    be trained."""
    bad = _quantized_paths(params)
    if bad:
        raise ValueError(
            "FSDP shards float training params; quantized leaves found at "
            f"{bad[:3]}... — dequantize or train LoRA adapters instead"
        )
    shardings = flux_fsdp_sharding(params, mesh, cfg, tensor_parallel=tensor_parallel,
                                   min_size=min_size)

    def place(p, s):
        if isinstance(p, dict):
            return {k: place(p[k], s[k]) for k in p}
        return Sharded.place(p, s.mesh, s.spec, copy=True)

    return place(params, shardings)
