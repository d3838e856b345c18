"""Normalization and adaptive-modulation ops.

Counterpart of the JAX package's `ops/norms.py`: RMSNorm and affine-free
LayerNorm with f32 accumulation and eps 1e-6, and the AdaLN modulation
SiLU -> Linear -> chunk into (shift, scale, gate) x {1, 2}, with int8 or int4
weights where the layer stack is quantized.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.ops.quant import dequantize_w4


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with f32 accumulation; output in x's dtype times scale."""
    xf = x.float()
    rrms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * rrms).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free layer norm with f32 accumulation (f64 for f64 inputs)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ModulationOut(NamedTuple):
    shift: torch.Tensor
    scale: torch.Tensor
    gate: torch.Tensor


def modulation(
    vec: torch.Tensor, w, b: torch.Tensor, double: bool
) -> Tuple[ModulationOut, Optional[ModulationOut]]:
    """silu(vec) @ w + b -> 3 or 6 chunks of [B, 1, D]. `w` may be an int8
    cell {"q" | "qa", "scale"} (the scale folds into the output; the w8a8
    form still computes in vec's dtype, as in the JAX package: the input is
    one vector per sample) or a w4 cell {"q4p", "gscale"} (dequantized)."""
    h = F.silu(vec)
    if isinstance(w, dict) and "q4p" in w:
        out = h @ dequantize_w4(w, vec.dtype) + b
    elif isinstance(w, dict):
        q = w["q"] if "q" in w else w["qa"]
        out = (h @ q.to(vec.dtype)) * w["scale"][0] + b
    else:
        out = h @ w + b
    out = out[:, None, :]
    chunks = out.chunk(6 if double else 3, dim=-1)
    mod2 = ModulationOut(*chunks[3:]) if double else None
    return ModulationOut(*chunks[:3]), mod2
