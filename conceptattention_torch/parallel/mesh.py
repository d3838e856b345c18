"""Device meshes: a (data, pipe, expert, seq, model) grid of torch devices.

Counterpart of the JAX package's `parallel/mesh.py`. `make_mesh` returns a
small `Mesh` with the grid, the axis names and `shape` as a dict, as
`jax.sharding.Mesh.shape` gives it. The axes:

  - `data`:   batch data parallelism (and FSDP's parameter shards);
  - `pipe`:   pipeline stages (`parallel/pipeline.py`);
  - `expert`: expert parallelism of MoE layers (`parallel/moe.py`);
  - `seq`:    the sequence ring (`parallel/ring_attention.py`);
  - `model`:  tensor parallelism over heads and MLP hidden units
              (`parallel/sharding.py`).

The same device may stand in the grid more than once:
`make_mesh(seq=4, devices=[torch.device("cuda:0")] * 4)` is a ring of four
ranks that share one card, and `[torch.device("cpu")] * 8` an 8-rank mesh
on the CPU. Ranks are entries of the grid; the port runs them from one
process (`parallel/collectives.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"
    seq: str = "seq"
    pipe: str = "pipe"
    expert: str = "expert"


AXES = MeshAxes()


class Mesh:
    """`devices`: an object array of `torch.device`s, one axis per name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices along `axis_name`, in rank order (every other axis at
        its first index)."""
        axis = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        index[axis] = slice(None)
        return list(self.devices[tuple(index)])

    def sub(self, **fixed: int) -> "Mesh":
        """The mesh of the ranks at the given index of each named axis (the
        axes stay, at size 1): `mesh.sub(data=1, model=0)`."""
        index = tuple(slice(fixed[a], fixed[a] + 1) if a in fixed else slice(None)
                      for a in self.axis_names)
        unknown = set(fixed) - set(self.axis_names)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return Mesh(self.devices[index], self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, first device {self.devices.flat[0]})"


def make_mesh(
    data: int = 1,
    model: int = 1,
    seq: int = 1,
    pipe: int = 1,
    expert: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Build a (data, pipe, expert, seq, model) mesh from `devices` (every
    visible CUDA device when None). `model` is innermost, so its ranks are
    neighbours in `devices` (the fastest links), `data` outermost. Raises
    when the mesh needs more devices than it is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes every visible CUDA device by default and none is available; "
                "pass devices=[torch.device('cpu')] * n to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = data * model * seq * pipe * expert
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(grid.reshape(data, pipe, expert, seq, model),
                (AXES.data, AXES.pipe, AXES.expert, AXES.seq, AXES.model))
