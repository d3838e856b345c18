"""Pieces shared by the reference models: float32 layers, RoPE tables,
attention, norms and the timestep embeddings."""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# Bytes of float32 scores one chunk of the materialized path may hold.
_SCORE_BYTES = 1 << 31
# What `linear` rounds its input and weight with (None: nothing), set by `rounded`.
_ROUND = None


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at e4m3's 448), back in float32: the precision below bf16."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def rounded(rnd):
    """Within the scope every linear layer and convolution rounds its input
    and its weight with `rnd` (`fp8`: the reference in float8, the cells'
    control)."""
    global _ROUND
    before, _ROUND = _ROUND, rnd
    try:
        yield
    finally:
        _ROUND = before


def operands(x: torch.Tensor, w: torch.Tensor):
    """(x, w) as the scope's rounding leaves them (`rounded`)."""
    return (x, w) if _ROUND is None else (_ROUND(x), _ROUND(w))


def layer_of(stack, i: int):
    """Layer i of a depth-stacked tree, upcast to float32."""
    if isinstance(stack, dict):
        return {k: layer_of(v, i) for k, v in stack.items()}
    return stack[i].float()


def linear(x: torch.Tensor, p) -> torch.Tensor:
    w = p["w"].float()
    x, w = operands(x, w.reshape(w.shape[0], -1))
    y = x @ w
    if "b" in p:
        y = y + p["b"].float().reshape(-1)
    return y


def layer_norm(x: torch.Tensor, w=None, b=None, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rope_tables(ids: torch.Tensor, axes_dim: Sequence[int],
                theta: float = 10_000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, n_axes] ids -> (cos, sin) [B, 1, N, sum(axes_dim) / 2], the
    angles in float64."""
    parts = []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        parts.append(ids[..., i].double()[..., None] * omega)
    ang = torch.cat(parts, dim=-1)[:, None]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved channel pairs (x[2i], x[2i+1]) of [B, H, N, D]."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1).flatten(-2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, H, L, D] x [B, H, M, D], float32.

    On a card: PyTorch's memory-efficient SDPA, whose float32 products
    keep float32 accuracy (on an H100, 1.5e-6 relative to float64 at
    17776 keys, against 7e-4 for TF32 and 6e-3 for bf16); materialized
    scores would take 1.3 GB a head of the CogVideoX block and several
    times the time. Elsewhere, the scores materialized in chunks."""
    b, h, l, d = q.shape
    m = k.shape[2]
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k, v))
    rows = max(1, _SCORE_BYTES // (4 * l * m))
    out = torch.empty_like(qf)
    for s in range(0, b * h, rows):
        scores = (qf[s:s + rows] @ kf[s:s + rows].transpose(1, 2)) * (1.0 / math.sqrt(d))
        out[s:s + rows] = torch.softmax(scores, dim=-1) @ vf[s:s + rows]
    return out.reshape(b, h, l, d)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def flux_timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Flux's sinusoidal embedding of t in [0, 1] (time factor 1000, cos then sin)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = 1000.0 * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embedder(x: torch.Tensor, p) -> torch.Tensor:
    return linear(F.silu(linear(x, p["in"])), p["out"])
