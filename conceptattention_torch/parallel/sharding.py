"""Sharding rules: Megatron-style tensor parallelism for the Flux DiT.

Counterpart of the JAX package's `parallel/sharding.py`. Per-leaf `P` specs
over the mesh of `parallel/mesh.py`:

  - fused qkv `[D, 3, H, Dh]`: the head axis H on `model` (column-parallel);
  - attention out-proj `[H*Dh, D]`: the input axis on `model`
    (row-parallel: the blocks sum the ranks' partial products before the
    one bias);
  - MLP in `[D, M]`: M on `model`; MLP out `[M, D]`: M (row-parallel);
  - modulation, embedders, norms: replicated (small);
  - per-layer stacks carry a leading depth axis: their specs shift by one.

Where JAX places a tree with `jax.device_put` and lets GSPMD run the dense
function, `shard_params` returns the tree with each leaf a
`collectives.Sharded` (its per-rank pieces), and the DiT
(`models/flux/dit.py`) runs tensor-parallel on such a tree: the layout
travels with the parameters. Activations: batch on `data`, the sequence
optionally on `seq`.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from conceptattention_torch.ops.quant import _is_quantized
from conceptattention_torch.parallel.collectives import (
    NamedSharding,
    P,
    Sharded,
    _is_sharded_cell,
)
from conceptattention_torch.parallel.mesh import AXES, Mesh


def _double_block_spec() -> Dict[str, Any]:
    tp = AXES.model
    spec = {}
    for stream in ("img", "txt"):
        spec[f"{stream}_mod"] = {"w": P(), "b": P()}
        spec[f"{stream}_qkv"] = {"w": P(None, None, tp, None), "b": P(None, tp, None)}
        spec[f"{stream}_qnorm"] = P()
        spec[f"{stream}_knorm"] = P()
        spec[f"{stream}_proj"] = {"w": P(tp, None), "b": P()}
        spec[f"{stream}_mlp_in"] = {"w": P(None, tp), "b": P(tp)}
        spec[f"{stream}_mlp_out"] = {"w": P(tp, None), "b": P()}
    return spec


def _single_block_spec() -> Dict[str, Any]:
    tp = AXES.model
    return {
        "mod": {"w": P(), "b": P()},
        "qkv": {"w": P(None, None, tp, None), "b": P(None, tp, None)},
        "mlp_in": {"w": P(None, tp), "b": P(tp)},
        "proj": {"w": P(tp, None), "b": P()},
        "mlp_out": {"w": P(tp, None)},
        "qnorm": P(),
        "knorm": P(),
    }


def _is_spec(x) -> bool:
    return isinstance(x, P)


def spec_map(fn, spec_tree):
    """fn over the `P` leaves of a spec tree."""
    if _is_spec(spec_tree):
        return fn(spec_tree)
    return {k: spec_map(fn, v) for k, v in spec_tree.items()}


def _prepend_layer_axis(spec_tree):
    """Stacked per-layer params have a leading depth axis -> shift specs."""
    return spec_map(lambda s: P(None, *s), spec_tree)


def flux_param_spec(cfg=None) -> Dict[str, Any]:
    """P tree matching init_flux_params' structure."""
    emb = {"in": {"w": P(), "b": P()}, "out": {"w": P(), "b": P()}}
    spec: Dict[str, Any] = {
        "img_in": {"w": P(), "b": P()},
        "txt_in": {"w": P(), "b": P()},
        "time_in": emb,
        "vector_in": {"in": {"w": P(), "b": P()}, "out": {"w": P(), "b": P()}},
        "final": {
            "adaln": {"w": P(), "b": P()},
            "linear": {"w": P(), "b": P()},
        },
        "double": _prepend_layer_axis(_double_block_spec()),
        "single": _prepend_layer_axis(_single_block_spec()),
    }
    if cfg is not None and cfg.guidance_embed:
        spec["guidance_in"] = {"in": {"w": P(), "b": P()}, "out": {"w": P(), "b": P()}}
    return spec


def flux_param_sharding(mesh: Mesh, cfg=None) -> Dict[str, Any]:
    return spec_map(lambda s: NamedSharding(mesh, s), flux_param_spec(cfg))


def _input_axis_fastest(lead: int):
    """The w8a8 layout of `ops.quant.int8_gemm_layout` for a piece with
    `lead` leading layer axes: input axis fastest, so each layer's [in,
    prod(out)] view is column-major, as the card's int8 GEMM wants."""
    def prepare(q: torch.Tensor) -> torch.Tensor:
        return q.movedim(lead, -1).contiguous().movedim(-1, lead)
    return prepare


def place_tree(params: Any, mesh: Mesh, spec_tree: Any, lead: int = 1) -> Any:
    """Lay a param tree out over `mesh` by a P tree: every leaf a `Sharded`.
    Keys the spec does not know replicate. Quantized cells: the int tensor
    takes the weight's spec; int8 per-channel scales replicate; w4 group
    scales take the weight's spec and replicate where their group count
    does not divide the mesh axis (the blocks cut them per rank). `lead`:
    the leading layer axes of the tree's w8a8 stacks (1 for depth stacks)."""
    rep = P()

    def place(p, s):
        if _is_quantized(p):
            if "q4p" in p:
                try:
                    gs = Sharded.place(p["gscale"], mesh, s)
                except ValueError:
                    gs = Sharded.place(p["gscale"], mesh, rep)
                return {"q4p": Sharded.place(p["q4p"], mesh, s), "gscale": gs}
            qk = "q" if "q" in p else "qa"
            prepare = _input_axis_fastest(lead) if qk == "qa" else torch.Tensor.contiguous
            return {qk: Sharded.place(p[qk], mesh, s, prepare=prepare),
                    "scale": Sharded.place(p["scale"], mesh, rep)}
        if isinstance(p, dict):
            return {k: place(p[k], s.get(k, rep) if isinstance(s, dict) else s) for k in p}
        if isinstance(p, (list, tuple)):
            return type(p)(place(a, b) for a, b in zip(p, s))
        return Sharded.place(p, mesh, s)

    return place(params, spec_tree)


def shard_params(params: Dict[str, Any], mesh: Mesh, cfg=None) -> Dict[str, Any]:
    """Place a param tree onto the mesh with the TP sharding rules: each
    leaf a `Sharded`, which `flux_forward` runs tensor-parallel (and data-
    parallel over `data`). Quantized cells as `place_tree` places them."""
    return place_tree(params, mesh, flux_param_spec(cfg))


def activation_sharding(mesh: Mesh, seq_sharded: bool = False) -> NamedSharding:
    """[B, L, D] activation sharding: batch on data, optionally seq on seq."""
    return NamedSharding(mesh, P(AXES.data, AXES.seq if seq_sharded else None, None))


def double_block_layer_spec() -> Dict[str, Any]:
    """Per-LAYER double-block specs (no depth axis): the `layer_param_spec`
    of pp x tp (`parallel/pipeline.pipeline_apply`)."""
    return _double_block_spec()


# -- trees of Sharded leaves ---------------------------------------------------------------------


def _walk(tree, leaf, cell=None):
    if cell is not None and _is_sharded_cell(tree):
        return cell(tree)
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, cell) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf, cell) for v in tree)
    return leaf(tree)


def tree_mesh(tree):
    """The mesh of the first `Sharded` leaf of a tree (None without one)."""
    if isinstance(tree, Sharded):
        return tree.mesh
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = tree_mesh(v)
            if m is not None:
                return m
    return None


def restrict_tree(tree, **fixed):
    """Every `Sharded` leaf restricted to `mesh.sub(**fixed)` (dimensions
    sharded over a fixed axis gathered whole)."""
    return _walk(tree, lambda x: x.restrict(**fixed) if isinstance(x, Sharded) else x)


def rank_tree(tree, coords):
    """Rank `coords`' plain tree: each leaf's piece (quantized cells' scales
    cut to the piece)."""
    from conceptattention_torch.parallel.collectives import cell_view

    return _walk(tree, lambda x: x.shard(coords) if isinstance(x, Sharded) else x,
                 cell=lambda c: cell_view(c, coords))


def gather_tree(tree, device=None):
    """The whole tree on one device (the mesh's first): what a dense model
    would hold."""
    return _walk(tree, lambda x: x.full(device) if isinstance(x, Sharded) else x)


def sharded_pieces(tree) -> List[torch.Tensor]:
    """Every distinct piece tensor of a tree's `Sharded` leaves (plain
    leaves as they are), in tree order: what an optimizer over the layout
    holds."""
    out: List[torch.Tensor] = []

    def collect(x):
        out.extend(x.pieces() if isinstance(x, Sharded) else [x])
        return x

    _walk(tree, collect)
    return out


def bytes_per_rank(tree, coords) -> int:
    """The bytes of the pieces rank `coords` holds."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, Sharded):
            total += x.nbytes_at(coords)
        elif torch.is_tensor(x):
            total += x.numel() * x.element_size()
        return x

    _walk(tree, add)
    return total


def replica_groups(tree) -> List[List[torch.Tensor]]:
    """The piece tensors that are copies of one piece on different devices
    (a dimension replicated across devices), one list per piece that has
    more than one copy. On a mesh of one device there are none: a
    replicated piece is one tensor there."""
    import numpy as np

    groups: List[List[torch.Tensor]] = []

    def visit(x):
        if isinstance(x, Sharded):
            by_key: Dict = {}
            for c in np.ndindex(x.grid.shape):
                key = tuple(c[x.mesh.axis_names.index(a)] for a in x.spec if a)
                copies = by_key.setdefault(key, [])
                if all(x.grid[c] is not t for t in copies):
                    copies.append(x.grid[c])
            groups.extend(copies for copies in by_key.values() if len(copies) > 1)
        return x

    _walk(tree, visit)
    return groups


def sum_replica_grads(groups: List[List[torch.Tensor]], grads: Dict[int, torch.Tensor]) -> None:
    """Replace the gradient of every copy in each group (`grads`, keyed by
    id of the piece) by the sum over the group's copies, so every copy takes
    the update of the one logical parameter."""
    from conceptattention_torch.parallel.collectives import psum

    for copies in groups:
        total = psum([grads[id(t)] for t in copies])
        for t, g in zip(copies, total):
            grads[id(t)] = g
