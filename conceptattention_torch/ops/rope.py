"""Multi-axis rotary position embeddings (RoPE).

Counterpart of the JAX package's `ops/rope.py`: theta 10_000, per-axis
dims `axes_dim`, rotation in f32 on interleaved (even, odd) channel pairs,
compact (cos, sin) tables of `[B, 1, N, D/2]`. The frequency ladder is
computed in float64 on the host.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _omega(dim: int, theta: int, device: torch.device) -> torch.Tensor:
    """The f32 frequency ladder on `device`, copied there once: a forward
    captured into a CUDA graph (`models/flux/dit.make_jitted_forward`) may
    not copy from the host."""
    scale = np.arange(0, dim, 2, dtype=np.float64) / dim
    return torch.as_tensor(1.0 / (float(theta) ** scale), dtype=torch.float32, device=device)


def rope_table(pos: torch.Tensor, dim: int, theta: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables `[..., N, dim // 2]` f32 for one id axis of `[..., N]` positions."""
    if dim % 2:
        raise ValueError(f"rope dim must be even, got {dim}")
    args = pos.float()[..., None] * _omega(dim, theta, pos.device)
    return torch.cos(args), torch.sin(args)


def embed_nd(
    ids: torch.Tensor, axes_dim: Sequence[int], theta: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`[B, N, n_axes]` position ids -> (cos, sin), each `[B, 1, N, head_dim // 2]` f32."""
    if ids.shape[-1] != len(axes_dim):
        raise ValueError(f"ids {tuple(ids.shape)} do not match axes_dim {axes_dim}")
    parts = [rope_table(ids[..., i], axes_dim[i], theta) for i in range(len(axes_dim))]
    cos = torch.cat([c for c, _ in parts], dim=-1)[:, None]
    sin = torch.cat([s for _, s in parts], dim=-1)[:, None]
    return cos, sin


def apply_rope(
    xq: torch.Tensor, xk: torch.Tensor, pe: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate the interleaved channel pairs `(x[2i], x[2i+1])` of q and k by
    the tables; f32 arithmetic, output in the input dtype."""
    cos, sin = pe

    def rot(x):
        xf = x.float().unflatten(-1, (-1, 2))
        x0, x1 = xf[..., 0], xf[..., 1]
        out = torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1)
        return out.flatten(-2).to(x.dtype)

    return rot(xq), rot(xk)
