"""Durable save and restore of trees of tensors (training state, weights).

Counterpart of the JAX package's `utils/checkpoint.py`, which saves through
orbax. A checkpoint here is a directory holding one `torch.save` file of the
tree with every tensor moved to the host. The write goes to a temporary
directory beside the target and is renamed over it only once complete, so a
run cut during a save leaves the previous checkpoint (or none), never half a
step. Trees are dicts, lists and tuples of tensors and plain Python values
(ints, floats, strings, booleans, None), which is what `torch.load` reads
back with `weights_only=True`.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch

from conceptattention_torch.models.flux.params import tree_map

_FILE = "tree.pt"


def save_params(path: str, params: Any) -> None:
    """Write `params` to the checkpoint directory `path`, replacing one
    already there."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    host = tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, params)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _like(like, saved, where: str):
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            raise ValueError(f"checkpoint leaf {where or '<root>'}: saved "
                             f"{getattr(saved, 'shape', type(saved).__name__)}, "
                             f"expected {tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"checkpoint node {where or '<root>'}: keys do not match")
        return {k: _like(like[k], saved[k], f"{where}.{k}") for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint node {where or '<root>'}: lengths do not match")
        return type(like)(_like(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(like, saved)))
    return saved


def load_params(path: str, like: Optional[Any] = None) -> Any:
    """Read the tree saved at `path`. With `like`, check that it has like's
    structure and shapes and put each tensor on like's device in like's
    dtype; without, return it as saved, on the host."""
    with open(os.path.join(os.path.abspath(path), _FILE), "rb") as f:
        saved = torch.load(f, map_location="cpu", weights_only=True)
    return saved if like is None else _like(like, saved, "")
