"""ViT with attention capture: the backbone of the baseline zoo.

Counterpart of the JAX package's `models/vit.py`. One functional ViT
serves the DINO and Chefer ViT-B/16 baselines: `vit_forward(...,
return_attn=True)` returns every layer's attention probabilities as one
[depth, B, H, N, N] stack, and `attn_deltas`, a tensor of that shape added to
the probabilities, lets `torch.autograd.grad` of a class logit with respect
to a zero delta give d(logit)/dA per layer (the Chefer methods' gradients).
The attention is written out (no `scaled_dot_product_attention`): the
methods read the probabilities themselves.

Parameters are the JAX package's tree: linear weights [in, out], the patch
conv as a [C*p*p, D] matmul weight in (c, py, px) order, blocks stacked along
a leading depth axis. The MLP's GELU is the tanh form (`jax.nn.gelu`'s
default); block LayerNorms use eps 1e-6, the final one `final_norm_eps`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.models.flux.params import _Init, layer, stack_layers
from conceptattention_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    # The Chefer explainability ViT leaves its final LayerNorm at torch's
    # default eps 1e-5 while its blocks use 1e-6; DINO uses 1e-6 throughout.
    final_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


def _linear(x, p):
    return x @ p["w"] + p["b"]


def _ln(x, p, eps: float = 1e-6):
    return layer_norm(x, eps=eps) * p["scale"] + p["bias"]


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] in (c, py, px) order: the
    patch conv's input as a matmul's."""
    b, c, _, w = images.shape
    g = w // patch_size
    x = images.reshape(b, c, g, patch_size, g, patch_size)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * patch_size * patch_size)


def embed(params, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """Patch embedding, the CLS token and the positions: [B, N+1, D]."""
    x = _linear(patchify(images, cfg.patch_size), params["patch_embed"])
    cls = params["cls_token"].expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"][:, : x.shape[1]]


def _attention(p, x, num_heads: int, delta=None):
    b, n, d = x.shape
    hd = d // num_heads
    qkv = _linear(x, p["qkv"]).reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    acc = torch.promote_types(q.dtype, torch.float32)  # f32 scores, f64 kept
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc))
    probs = torch.softmax(logits / (hd**0.5), dim=-1)
    if delta is not None:
        probs = probs + delta  # zero in the forward; carries dlogit/dA backward
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    out = out.permute(0, 2, 1, 3).reshape(b, n, d)
    return _linear(out, p["proj"]), probs


def vit_block(p, x, num_heads: int, delta=None):
    attn_out, probs = _attention(p["attn"], _ln(x, p["norm1"]), num_heads, delta)
    x = x + attn_out
    h = _linear(F.gelu(_linear(_ln(x, p["norm2"]), p["mlp_in"]), approximate="tanh"),
                p["mlp_out"])
    return x + h, probs


def vit_forward(
    params: Dict[str, Any],
    cfg: ViTConfig,
    images: torch.Tensor,
    return_attn: bool = False,
    attn_deltas: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """images [B, 3, H, W] -> (logits [B, num_classes], the attention stack
    [depth, B, H, N+1, N+1] when `return_attn`, else None).

    `attn_deltas` (the stack's shape) is added to each layer's attention
    probabilities: the gradient of a logit with respect to a zero delta is
    d(logit)/dA per layer."""
    x = embed(params, cfg, images)
    attns = []
    for i in range(cfg.depth):
        delta = None if attn_deltas is None else attn_deltas[i]
        x, probs = vit_block(layer(params["blocks"], i), x, cfg.num_heads, delta)
        if return_attn:
            attns.append(probs)
    x = _ln(x, params["norm"], eps=cfg.final_norm_eps)
    logits = _linear(x[:, 0], params["head"])
    return logits, torch.stack(attns) if return_attn else None


def init_vit_params(generator: torch.Generator, cfg: ViTConfig,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters on the generator's device, in the JAX package's
    scales: linear weights N(0, 1/din) with zero biases, unit LayerNorms,
    the CLS token and positions N(0, 0.02^2)."""
    init = _Init(generator, dtype)
    d, m = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)

    def ln():
        return {"scale": init.const((d,), 1.0), "bias": init.const((d,), 0.0)}

    def block(_):
        return {
            "norm1": ln(),
            "attn": {"qkv": init.linear(d, 3 * d), "proj": init.linear(d, d)},
            "norm2": ln(),
            "mlp_in": init.linear(d, m),
            "mlp_out": init.linear(m, d),
        }

    return {
        "blocks": stack_layers(block, cfg.depth),
        "patch_embed": init.linear(cfg.in_channels * cfg.patch_size**2, d),
        "cls_token": init.normal((1, 1, d), 0.02),
        "pos_embed": init.normal((1, cfg.num_patches + 1, d), 0.02),
        "norm": ln(),
        "head": init.linear(d, cfg.num_classes),
    }
