"""Pipeline parallelism (pp) over a stacked layer tree: the GPipe schedule.

Counterpart of the JAX package's `parallel/pipeline.py`. The DiT is a stack
of identical blocks with parameters stacked on a leading depth axis:

  - the [depth, ...] stack is split into `pipe` contiguous stages, stage s
    resident on the ranks at index s of the mesh's `pipe` axis;
  - the batch is split into microbatches; on each tick every stage applies
    its layer chunk to one microbatch and hands the boundary activation to
    the next stage's device (the `ppermute` hop); weights never move;
  - M microbatches over S stages take M + S - 1 ticks (the bubble);
    utilization M / (M + S - 1).

The port steps the ticks from one process: on a tick each stage with a
microbatch runs in turn, and a stage's kernels on its own device overlap
with the next stage's as the devices run asynchronously. Stages in a
bubble do nothing (the JAX program computes on zeros there).

`layer_param_spec` (pp x tp) lays each stage's layers out over the `model`
ranks of its stage (`parallel.sharding.place_tree`), so `layer_fn` must be
tensor-parallel, e.g. `double_block(..., tp_axis="model")`. `batch_axis`
(pp x dp) splits every microbatch's rows over that axis: each data index
runs the whole schedule on its rows, on its own stage ranks.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from conceptattention_torch.models.flux.params import layer, tree_leaves, tree_map
from conceptattention_torch.parallel.sharding import place_tree


def _leading(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _zip_map(fn, trees: List[Any]):
    """fn over matching leaves of a list of trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, [t[i] for t in trees]) for i in range(len(first)))
    return fn(trees)


def pipeline_apply(
    layer_fn: Callable[[Any, Any], Any],
    stacked_params: Any,
    carry: Any,
    mesh,
    axis: str = "pipe",
    num_microbatches: Optional[int] = None,
    with_outputs: bool = False,
    layer_param_spec: Any = None,
    shape_probe_fn: Optional[Callable[[Any, Any], Any]] = None,
    batch_axis: Optional[str] = None,
) -> Any:
    """Apply `depth` stacked layers to `carry` with GPipe pipelining.

    layer_fn(layer_params, carry) -> carry applies ONE layer (closures may
    capture side inputs). `stacked_params` leaves are [depth, ...] with
    depth % stages == 0; `carry` leaves are [batch, ...] with batch %
    num_microbatches == 0 (and the microbatch rows % the `batch_axis` size).

    With `with_outputs=True`, layer_fn returns (carry, y) per layer and
    pipeline_apply returns (carry, ys): batch-leading y leaves (leading
    dimension the rows the layer saw, as saliency maps [B, C, P]) come back
    stacked [depth, batch, ...], as a sequential loop over the layers would
    give them; other leaves (per-layer scalars, vectors) come back [depth,
    num_microbatches, ...], one value per microbatch (the first data
    index's under `batch_axis`).

    `layer_param_spec`: a per-LAYER spec tree (no depth axis, e.g.
    `sharding.double_block_layer_spec()`) laying each stage's layers out
    over the other mesh axes; layer_fn must then be tensor-parallel.
    `shape_probe_fn` is accepted for the JAX signature, where it traces the
    outputs' shapes; the port runs the layers and needs none.

    Equals applying the layers in order to the whole batch; the outputs
    (and gradients, through autograd) come back on the mesh's first device.
    """
    del shape_probe_fn
    stages = mesh.shape[axis]
    depth = _leading(stacked_params)
    if depth % stages != 0:
        raise ValueError(f"depth {depth} not divisible by {stages} pipe stages")
    m = num_microbatches or stages
    batch = _leading(carry)
    if batch % m != 0:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    mb = batch // m
    n_data = mesh.shape[batch_axis] if batch_axis else 1
    if mb % n_data:
        raise ValueError(f"microbatch of {mb} rows not divisible by {batch_axis}={n_data}")
    rows = mb // n_data
    per_stage = depth // stages
    first = mesh.devices.flat[0]

    def stage_mesh(s, d):
        fixed = {axis: s}
        if batch_axis:
            fixed[batch_axis] = d
        return mesh.sub(**fixed)

    def stage_params(s, d):
        sub = stage_mesh(s, d)
        out = []
        for i in range(s * per_stage, (s + 1) * per_stage):
            lp = layer(stacked_params, i)
            if layer_param_spec is not None:
                lp = place_tree(lp, sub, layer_param_spec, lead=0)
            else:
                dev = sub.devices.flat[0]
                lp = tree_map(lambda x: x.to(dev), lp)
            out.append(lp)
        return out

    outs_by_slice, ys_by_slice = [], []
    for d in range(n_data):
        params = [stage_params(s, d) for s in range(stages)]
        devices = [stage_mesh(s, d).devices.flat[0] for s in range(stages)]

        def micro(j, d=d):
            lo = j * mb + d * rows
            return tree_map(lambda a: a[lo:lo + rows].to(devices[0]), carry)

        outs: List[Any] = [None] * m
        ys: List[List[Any]] = [[None] * m for _ in range(depth)]  # [layer][microbatch]
        state: List[Any] = [None] * stages
        for t in range(m + stages - 1):
            handed: List[Any] = [None] * stages
            for s in range(stages):
                j = t - s  # the microbatch stage s holds on this tick
                if not 0 <= j < m:
                    continue
                x = micro(j) if s == 0 else state[s]
                for k, lp in enumerate(params[s]):
                    if with_outputs:
                        x, y = layer_fn(lp, x)
                        ys[s * per_stage + k][j] = y
                    else:
                        x = layer_fn(lp, x)
                if s == stages - 1:
                    outs[j] = x
                else:  # the boundary hop to the next stage
                    handed[s + 1] = tree_map(lambda a: a.to(devices[s + 1]), x)
            state = handed
        outs_by_slice.append(outs)
        ys_by_slice.append(ys)

    # [microbatch][data] pieces of rows -> [batch, ...] in the caller's row order
    carry_out = _zip_map(lambda xs: torch.cat([x.to(first) for x in xs]),
                         [outs_by_slice[d][j] for j in range(m) for d in range(n_data)])
    if not with_outputs:
        return carry_out

    def assemble(layer_ys):
        def leaf(pieces):  # pieces ordered [microbatch][data]
            if pieces[0].dim() >= 1 and pieces[0].shape[0] == rows:
                return torch.cat([p.to(first) for p in pieces])
            return torch.stack([pieces[j * n_data].to(first) for j in range(m)])
        return _zip_map(leaf, [layer_ys[d][j] for j in range(m) for d in range(n_data)])

    per_layer = [assemble([ys_by_slice[d][i] for d in range(n_data)]) for i in range(depth)]
    ys_out = _zip_map(torch.stack, per_layer)
    return carry_out, ys_out
