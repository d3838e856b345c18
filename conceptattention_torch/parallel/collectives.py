"""The ranks of a mesh, run from one process: collectives, a per-rank runner
and tensors laid out over a mesh.

Counterpart of the JAX package's `parallel/_compat.shard_map_compat` and of
the GSPMD layouts (`NamedSharding`) it works with. The port has no GSPMD:
one process steps every rank of a `parallel.mesh.Mesh`, a rank being an
entry of the mesh's device grid (the same device may stand there more than
once), and a sharded value is a list of per-rank shards.

- Collectives on lists of shards, in rank order: `psum`, `pmax`, `pmean`,
  `all_gather` (tiled: the shards concatenated), `all_to_all` (tiled) and
  `ppermute`. They are copies and sums, so autograd flows through them.
  Where two ranks share a device, the result there is one tensor.
- `shard_map(body, mesh, in_specs, out_specs)`: runs `body(rank, *shards)`
  once for each rank of `mesh`. A body that is a generator asks for a
  collective by yielding it, `y = yield lax.psum(y, "model")`; the runner
  steps every rank to its next request, runs the collective over each
  group of ranks along the named axis, and sends each rank its result, so
  bodies read as JAX's `shard_map` bodies do.
- `Sharded`: a tensor laid out over a mesh by a `P` spec (one mesh axis or
  None per dimension), held as a grid of per-rank pieces; a replicated
  piece is one tensor per device.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from conceptattention_torch.parallel.mesh import Mesh

Shards = List[torch.Tensor]


class P(tuple):
    """A partition spec: the mesh axis (or None) of each leading dimension,
    as `jax.sharding.PartitionSpec`; trailing dimensions are whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as `jax.sharding.NamedSharding`."""

    mesh: Mesh
    spec: P


def _full_spec(spec, ndim: int) -> Tuple[Optional[str], ...]:
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dimensions")
    return spec + (None,) * (ndim - len(spec))


def _axis(mesh: Mesh, name: str) -> int:
    return mesh.axis_names.index(name)


# -- collectives over lists of shards -----------------------------------------------------


def _per_device(xs: Sequence[torch.Tensor], make: Callable[[torch.device], torch.Tensor]) -> Shards:
    """make(device) once for each distinct device of xs; one entry per rank."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for x in xs:
        if x.device not in done:
            done[x.device] = make(x.device)
        out.append(done[x.device])
    return out


def psum(xs: Sequence[torch.Tensor]) -> Shards:
    """The sum of every rank's shard, in rank order, on every rank."""
    def total(dev):
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        return acc
    return _per_device(xs, total)


def pmax(xs: Sequence[torch.Tensor]) -> Shards:
    def most(dev):
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = torch.maximum(acc, x.to(dev))
        return acc
    return _per_device(xs, most)


def pmean(xs: Sequence[torch.Tensor]) -> Shards:
    return [s / len(xs) for s in psum(xs)]


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> Shards:
    """Every rank's shard concatenated along `dim`, on every rank."""
    return _per_device(xs, lambda dev: torch.cat([x.to(dev) for x in xs], dim))


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int) -> Shards:
    """Tiled all-to-all: rank i splits its shard along `split_dim` into one
    chunk per rank; rank j receives chunk j of every rank, concatenated
    along `concat_dim` in rank order."""
    n = len(xs)
    chunks = [x.chunk(n, split_dim) for x in xs]
    if any(len(c) != n for c in chunks) or xs[0].shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {xs[0].shape[split_dim]} does not split over {n} ranks")
    return [torch.cat([chunks[i][j].to(xs[j].device) for i in range(n)], concat_dim)
            for j in range(n)]


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Shards:
    """Rank dst receives rank src's shard for each (src, dst) of `perm`;
    a rank that receives nothing gets zeros."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out


_OPS = {"psum": psum, "pmax": pmax, "pmean": pmean, "all_gather": all_gather,
        "all_to_all": all_to_all, "ppermute": ppermute}


def _tree_apply(fn: Callable[[List[torch.Tensor]], Shards], values: List[Any]) -> List[Any]:
    """fn over the ranks' matching leaves of trees of dicts, lists and tuples."""
    first = values[0]
    if isinstance(first, dict):
        per_key = {k: _tree_apply(fn, [v[k] for v in values]) for k in first}
        return [{k: per_key[k][r] for k in first} for r in range(len(values))]
    if isinstance(first, (list, tuple)):
        per_item = [_tree_apply(fn, [v[i] for v in values]) for i in range(len(first))]
        return [type(first)(item[r] for item in per_item) for r in range(len(values))]
    return fn(list(values))


class Collective(NamedTuple):
    """A collective a rank body asks for by yielding it."""

    op: str
    axis: str
    value: Any
    kwargs: Dict[str, Any]


class lax:
    """The collectives a generator body yields, named as `jax.lax`'s."""

    @staticmethod
    def psum(x, axis_name: str) -> Collective:
        return Collective("psum", axis_name, x, {})

    @staticmethod
    def pmax(x, axis_name: str) -> Collective:
        return Collective("pmax", axis_name, x, {})

    @staticmethod
    def pmean(x, axis_name: str) -> Collective:
        return Collective("pmean", axis_name, x, {})

    @staticmethod
    def all_gather(x, axis_name: str, dim: int = 0) -> Collective:
        return Collective("all_gather", axis_name, x, {"dim": dim})

    @staticmethod
    def all_to_all(x, axis_name: str, split_dim: int, concat_dim: int) -> Collective:
        return Collective("all_to_all", axis_name, x,
                          {"split_dim": split_dim, "concat_dim": concat_dim})

    @staticmethod
    def ppermute(x, axis_name: str, perm: Sequence[Tuple[int, int]]) -> Collective:
        return Collective("ppermute", axis_name, x, {"perm": list(perm)})


# -- the per-rank runner ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rank:
    """Where a body runs: its coordinates on the mesh and its device."""

    mesh: Mesh
    coords: Tuple[int, ...]
    device: torch.device

    def index(self, axis_name: str) -> int:
        return self.coords[_axis(self.mesh, axis_name)]


def run_bodies(gens: List[Any], ranks: List[Rank]) -> List[Any]:
    """Step generator bodies in lock step, serving the collectives they
    yield; non-generator results pass through. Returns each body's result."""
    if not any(inspect.isgenerator(g) for g in gens):
        return gens
    if not all(inspect.isgenerator(g) for g in gens):
        raise RuntimeError("some rank bodies are generators and some are not")
    results: List[Any] = [None] * len(gens)
    finished = [False] * len(gens)
    sends: List[Any] = [None] * len(gens)
    while True:
        requests = []
        for r, g in enumerate(gens):
            try:
                requests.append(g.send(sends[r]))
            except StopIteration as stop:
                finished[r] = True
                results[r] = stop.value
                requests.append(None)
        if all(finished):
            return results
        if any(finished):
            raise RuntimeError("rank bodies diverged: some finished while others wait on a collective")
        first = requests[0]
        if not all(isinstance(q, Collective) and (q.op, q.axis) == (first.op, first.axis)
                   for q in requests):
            raise RuntimeError(f"rank bodies asked for different collectives: "
                               f"{[(getattr(q, 'op', q), getattr(q, 'axis', None)) for q in requests]}")
        mesh = ranks[0].mesh
        a = _axis(mesh, first.axis)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for r, rank in enumerate(ranks):
            key = rank.coords[:a] + rank.coords[a + 1:]
            groups.setdefault(key, []).append(r)
        op = _OPS[first.op]
        for members in groups.values():
            members.sort(key=lambda r: ranks[r].coords[a])
            out = _tree_apply(lambda xs: op(xs, **first.kwargs), [requests[r].value for r in members])
            for r, value in zip(members, out):
                sends[r] = value


def _local(arg, spec, rank: Rank, moved: Dict):
    """Rank `rank`'s shard of an argument: a `Sharded` leaf's piece (a
    quantized cell's scales cut to its piece), a tensor cut by `spec` and
    moved to the rank's device (one copy per device), a tree of these, or
    anything else as it is."""
    if isinstance(arg, Sharded):
        return arg.shard(rank.coords)
    if isinstance(arg, dict):
        if _is_sharded_cell(arg):
            return cell_view(arg, rank.coords)
        specs = spec if isinstance(spec, dict) else {}
        return {k: _local(v, specs.get(k, spec if not isinstance(spec, dict) else None), rank, moved)
                for k, v in arg.items()}
    if isinstance(arg, (list, tuple)) and not isinstance(arg, P):
        specs = spec if isinstance(spec, (list, tuple)) and not isinstance(spec, P) else [spec] * len(arg)
        return type(arg)(_local(v, s, rank, moved) for v, s in zip(arg, specs))
    if not torch.is_tensor(arg):
        return arg
    full = _full_spec(spec, arg.dim())
    key = (id(arg), tuple(rank.coords[_axis(rank.mesh, a)] for a in full if a), rank.device)
    if key not in moved:
        moved[key] = _cut(arg, full, rank.mesh, rank.coords).to(rank.device)
    return moved[key]


def _cut(x: torch.Tensor, spec, mesh: Mesh, coords) -> torch.Tensor:
    """The piece of x at `coords` under `spec` (a view)."""
    for d, a in enumerate(spec):
        if a is None:
            continue
        n = mesh.shape[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} is not divisible by mesh axis "
                             f"{a!r} of size {n}")
        size = x.shape[d] // n
        x = x.narrow(d, coords[_axis(mesh, a)] * size, size)
    return x


def _join(get: Callable[[Tuple[int, ...]], torch.Tensor], spec, mesh: Mesh, base, device):
    """The pieces get(coords) reassembled along every dimension that `spec`
    shards, from the ranks that share `base`'s other coordinates, on
    `device`."""
    axes = [(d, a) for d, a in enumerate(spec) if a is not None]

    def rec(k, coords):
        if k == len(axes):
            return get(tuple(coords)).to(device)
        d, a = axes[k]
        i = _axis(mesh, a)
        parts = []
        for j in range(mesh.shape[a]):
            c = list(coords)
            c[i] = j
            parts.append(rec(k + 1, c))
        return torch.cat(parts, d) if len(parts) > 1 else parts[0]

    return rec(0, list(base))


def _assemble(results: List[Any], out_spec, ranks: List[Rank]):
    """The ranks' outputs as whole values on the first rank's device: each
    leaf joined along the dimensions its spec shards (a replicated leaf is
    rank 0's)."""
    mesh = ranks[0].mesh
    by_coords = {rank.coords: r for r, rank in enumerate(ranks)}
    device = ranks[0].device

    def rec(values, spec):
        first = values[0]
        if isinstance(first, dict):
            specs = spec if isinstance(spec, dict) else {k: spec for k in first}
            return {k: rec([v[k] for v in values], specs.get(k)) for k in first}
        if isinstance(first, (list, tuple)):
            specs = (spec if isinstance(spec, (list, tuple)) and not isinstance(spec, P)
                     else [spec] * len(first))
            return type(first)(rec([v[i] for v in values], s) for i, s in enumerate(specs))
        if not torch.is_tensor(first):
            return first
        full = _full_spec(spec, first.dim())
        return _join(lambda c: values[by_coords[c]], full, mesh, ranks[0].coords, device)

    return rec(results, out_spec)


def shard_map(body: Callable, mesh: Mesh, in_specs: Sequence, out_specs):
    """`jax.shard_map`'s counterpart: a callable that cuts each argument into
    one shard per rank of `mesh` (`Sharded` leaves give their pieces; a
    tensor is cut by its spec, `None` or `P()` replicating it), runs
    `body(rank, *shards)` for every rank (generator bodies in lock step with
    their collectives), and joins the outputs by `out_specs` on the mesh's
    first device. Specs may be trees matching the arguments and outputs."""

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        ranks = [Rank(mesh, c, mesh.devices[c]) for c in np.ndindex(mesh.devices.shape)]
        moved: Dict = {}
        gens = [body(rank, *[_local(a, s, rank, moved) for a, s in zip(args, in_specs)])
                for rank in ranks]
        return _assemble(run_bodies(gens, ranks), out_specs, ranks)

    return run


def drive(gen):
    """The result of a generator body run as a single rank: it must ask
    for no collective."""
    if not inspect.isgenerator(gen):
        return gen
    try:
        request = gen.send(None)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"a single-rank body asked for a collective: {request.op} over {request.axis}")


# -- tensors laid out over a mesh ---------------------------------------------------------------


class Sharded:
    """A tensor of global `shape` laid out over `mesh` by `spec`: `grid`
    holds each rank's piece (an object array shaped like the mesh). Ranks
    that share a device and their index along every axis the spec names
    share one piece tensor."""

    def __init__(self, mesh: Mesh, spec, grid: np.ndarray, shape: torch.Size):
        self.mesh = mesh
        self.spec = _full_spec(spec, len(shape))
        self.grid = grid
        self.shape = torch.Size(shape)

    @classmethod
    def place(cls, x: torch.Tensor, mesh: Mesh, spec,
              prepare: Callable[[torch.Tensor], torch.Tensor] = torch.Tensor.contiguous,
              copy: bool = False) -> "Sharded":
        """x laid out over `mesh`: each piece cut by `spec`, moved to its
        rank's device and passed through `prepare` once per (piece, device).
        A piece on x's own device may share x's storage (a replicated piece
        is x itself) unless `copy`."""
        full = _full_spec(spec, x.dim())
        for a in full:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"spec {full} names {a!r}, not an axis of the mesh")
        grid = np.empty(mesh.devices.shape, dtype=object)
        made: Dict = {}
        for c in np.ndindex(grid.shape):
            dev = mesh.devices[c]
            key = (tuple(c[_axis(mesh, a)] for a in full if a), dev)
            if key not in made:
                piece = prepare(_cut(x, full, mesh, c).to(dev))
                if (copy and piece.device == x.device
                        and piece.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()):
                    piece = piece.clone()
                made[key] = piece
            grid[c] = made[key]
        return cls(mesh, full, grid, x.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.grid.flat[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]

    def dim(self) -> int:
        return len(self.shape)

    def shard(self, coords) -> torch.Tensor:
        return self.grid[tuple(coords)]

    def pieces(self) -> List[torch.Tensor]:
        """The distinct piece tensors, each once."""
        seen, out = set(), []
        for t in self.grid.flat:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        """fn applied to each distinct piece (keeping the sharing); fn must
        keep the shape."""
        done: Dict[int, torch.Tensor] = {}
        grid = np.empty(self.grid.shape, dtype=object)
        for c in np.ndindex(grid.shape):
            t = self.grid[c]
            if id(t) not in done:
                done[id(t)] = fn(t)
            grid[c] = done[id(t)]
        return Sharded(self.mesh, self.spec, grid, self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, reassembled on `device` (the mesh's first)."""
        device = device or self.device
        return _join(self.shard, self.spec, self.mesh, (0,) * self.mesh.devices.ndim, device)

    def __getitem__(self, i: int) -> "Sharded":
        """Index i of the leading dimension. Where the spec shards that
        dimension, the owning rank's row goes to every rank (a broadcast),
        so the result is replicated along that axis."""
        if not isinstance(i, int):
            raise TypeError("a Sharded tensor takes an int index on its leading dimension")
        i = i % self.shape[0]
        a = self.spec[0]
        grid = np.empty(self.grid.shape, dtype=object)
        done: Dict = {}
        if a is None:
            for c in np.ndindex(grid.shape):
                t = self.grid[c]
                if id(t) not in done:
                    done[id(t)] = t[i]
                grid[c] = done[id(t)]
        else:
            ax = _axis(self.mesh, a)
            local = self.shape[0] // self.mesh.shape[a]
            for c in np.ndindex(grid.shape):
                owner = list(c)
                owner[ax] = i // local
                src = self.grid[tuple(owner)]
                dev = self.mesh.devices[c]
                if (id(src), dev) not in done:
                    done[(id(src), dev)] = src[i % local].to(dev)
                grid[c] = done[(id(src), dev)]
        return Sharded(self.mesh, self.spec[1:], grid, self.shape[1:])

    def restrict(self, **fixed: int) -> "Sharded":
        """The layout on `mesh.sub(**fixed)`: the ranks at those indices.
        A dimension that the spec shards over a fixed axis is gathered
        whole (FSDP's all-gather); the rest is the same pieces."""
        gather = tuple(a if (a in fixed and self.mesh.shape[a] > 1) else None for a in self.spec)
        sub = self.mesh.sub(**fixed)
        spec = tuple(None if a in fixed else a for a in self.spec)
        grid = np.empty(sub.devices.shape, dtype=object)
        made: Dict = {}
        for c in np.ndindex(grid.shape):
            full_c = tuple(fixed[a] if a in fixed else c[k] for k, a in enumerate(self.mesh.axis_names))
            if not any(gather):
                grid[c] = self.grid[full_c]
                continue
            dev = sub.devices[c]
            piece = (tuple(full_c[_axis(self.mesh, a)] for a in spec if a), dev)
            if piece not in made:
                made[piece] = _join(self.shard, gather, self.mesh, full_c, dev)
            grid[c] = made[piece]
        return Sharded(sub, spec, grid, self.shape)

    def nbytes_at(self, coords) -> int:
        t = self.shard(coords)
        return t.numel() * t.element_size()

    def __repr__(self) -> str:
        return f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, {self.mesh})"


_CELL_WEIGHTS = ("qa", "q", "q4p")


def _is_sharded_cell(node) -> bool:
    """A quantized cell ({"q"|"qa", "scale"} / {"q4p", "gscale"}) whose
    weight is laid out over a mesh."""
    return (isinstance(node, dict) and len(node) == 2
            and any(isinstance(node.get(k), Sharded) for k in _CELL_WEIGHTS)
            and ("scale" in node or "gscale" in node))


def cell_view(cell: Dict[str, Any], coords) -> Dict[str, torch.Tensor]:
    """A rank's piece of a quantized cell. The scales replicate when they do
    not shard with the weight, so they are cut here to the rank's piece:
    per-channel scales along the output dims the weight shards; a w4 cell's
    group scales along its input (group) axis to the groups of the rank's
    rows, or, where those rows do not start and end on a group boundary, to
    one scale per row (a w4 cell of group 1)."""
    wkey = next(k for k in _CELL_WEIGHTS if k in cell)
    skey = "gscale" if wkey == "q4p" else "scale"
    w, s = cell[wkey], cell[skey]
    wl = w.shard(coords)
    sl = s.shard(coords) if isinstance(s, Sharded) else s.to(wl.device)
    s_spec = s.spec if isinstance(s, Sharded) else (None,) * s.dim()
    group_axis = None
    if wkey == "q4p":
        group_axis = next(d for d in range(len(w.shape)) if w.shape[d] != s.shape[d])
    for d, a in enumerate(w.spec):
        if a is None or s_spec[d] is not None or w.mesh.shape[a] == 1:
            continue
        n, idx = w.mesh.shape[a], coords[_axis(w.mesh, a)]
        if d != group_axis:
            if sl.shape[d] == w.shape[d]:
                size = w.shape[d] // n
                sl = sl.narrow(d, idx * size, size)
            continue
        rows = 2 * w.shape[d]  # the unpacked input axis
        g = rows // s.shape[d]
        local, start = rows // n, idx * (rows // n)
        if start % g == 0 and local % g == 0:
            sl = sl.narrow(d, start // g, local // g)
        else:
            sl = sl.repeat_interleave(g, dim=d).narrow(d, start, local)
    return {wkey: wl, skey: sl}
