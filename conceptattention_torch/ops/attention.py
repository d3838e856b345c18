"""Attention ops: the two-SDPA reference path and the joint (txt|concept)+img
attention contract.

Counterpart of the JAX package's `ops/attention.py`. A txt+img joint
attention over `[txt; img]` plus a concept pass in which concept queries
attend over `[concept; img]` keys with their own softmax denominator. Image
tokens never attend to concepts, so generation is unmodified by the concept
stream.

`joint_concept_attention` dispatches on `ConceptAttentionSpec.backend`:
"fused" (the default, the model's path) runs both passes through one launch
of the flash-saliency kernel (`kernels/flash_saliency.py`); "sdpa" runs the
two plain SDPA calls below, the reference the kernel is held against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ConceptAttentionSpec:
    """Static configuration of the concept pass."""

    cross_attention: bool = True
    self_attention: bool = True
    # Which similarity taps to emit as per-layer saliency maps
    # ("output", "cross_attention", "value").
    taps: Tuple[str, ...] = ("output", "cross_attention")
    # "fused" (one flash-saliency kernel launch) or "sdpa" (two plain SDPAs).
    backend: str = "fused"
    # Per-row int8 q and k with int8 x int8 -> int32 scores (the fused
    # backend's K1b); no other backend computes them.
    int8_qk: bool = False
    # Storage dtype of the per-step saliency stash: None keeps f32, "bf16"
    # rounds only the stacked copy (similarities are computed in f32).
    stash_dtype: Optional[str] = None


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D]."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def split_qkv(qkv: torch.Tensor, num_heads: int):
    """[B, L, 3*H*D] fused projection, laid out (k, h, d) -> three [B, H, L, D]."""
    b, l, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    x = qkv.reshape(b, l, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, L, D]: f32 logits and softmax,
    weights cast to v's dtype, f32 accumulation, output in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return (weights.to(v.dtype).float() @ v.float()).to(v.dtype)


def joint_concept_attention(
    txt_qkv, img_qkv, concept_qkv, pe, concept_pe,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
):
    """Joint txt+img attention plus the optional concept pass.

    Args:
      txt_qkv/img_qkv/concept_qkv: per-segment (q, k, v), each [B, H, L, D],
        QK-normalized but not yet roped.
      pe: (cos, sin) tables for the [txt; img] sequence.
      concept_pe: (cos, sin) tables for the [concept; img] sequence.

    Returns (txt_attn, img_attn, concept_attn, extras): merged-head
    [B, L, H*D] outputs (concept_attn None without concepts) and the
    pre-RoPE q/k/v plus head-form outputs for the saliency taps.
    """
    if spec.int8_qk and spec.backend != "fused":
        raise ValueError(
            f"ConceptAttentionSpec(int8_qk=True) requires the fused attention backend, "
            f"got {spec.backend!r}"
        )
    if spec.backend == "fused":
        from conceptattention_torch.kernels.flash_saliency import (
            joint_concept_attention_fused,
        )

        return joint_concept_attention_fused(
            txt_qkv, img_qkv, concept_qkv, pe, concept_pe,
            cross=spec.cross_attention, self_attention=spec.self_attention,
            int8_qk=spec.int8_qk,
        )
    if spec.backend != "sdpa":
        raise ValueError(f"unknown attention backend {spec.backend!r}")
    from conceptattention_torch.ops.rope import apply_rope

    txt_q, txt_k, txt_v = txt_qkv
    img_q, img_k, img_v = img_qkv
    t = txt_q.shape[2]
    cos, sin = pe
    txt_q_r, txt_k_r = apply_rope(txt_q, txt_k, (cos[:, :, :t], sin[:, :, :t]))
    img_q_r, img_k_r = apply_rope(img_q, img_k, (cos[:, :, t:], sin[:, :, t:]))

    attn = sdpa(
        torch.cat([txt_q_r, img_q_r], dim=2),
        torch.cat([txt_k_r, img_k_r], dim=2),
        torch.cat([txt_v, img_v], dim=2),
    )
    txt_attn = merge_heads(attn[:, :, :t])
    img_attn = merge_heads(attn[:, :, t:])
    if concept_qkv is None:
        return txt_attn, img_attn, None, {}

    con_q, con_k, con_v = concept_qkv
    c = con_q.shape[2]
    ccos, csin = concept_pe
    # concept_pe's image segment equals pe's (both come from img_ids), so the
    # roped image q/k are reused.
    con_q_r, con_k_r = apply_rope(con_q, con_k, (ccos[:, :, :c], csin[:, :, :c]))
    if spec.cross_attention and spec.self_attention:
        concept_attn = sdpa(
            torch.cat([con_q_r, img_q_r], dim=2),
            torch.cat([con_k_r, img_k_r], dim=2),
            torch.cat([con_v, img_v], dim=2),
        )[:, :, :c]
    elif spec.cross_attention:
        concept_attn = sdpa(con_q_r, img_k_r, img_v)
    elif spec.self_attention:
        concept_attn = sdpa(con_q_r, con_k_r, con_v)
    else:
        concept_attn = con_v

    extras = {
        "concept_q": con_q,
        "concept_k": con_k,
        "img_q": img_q,
        "concept_v": con_v,
        "img_v": img_v,
        "concept_out_h": concept_attn,
        "img_out_h": attn[:, :, t:],
    }
    return txt_attn, img_attn, merge_heads(concept_attn), extras


def similarity_map_heads(concept_vectors: torch.Tensor, image_vectors: torch.Tensor) -> torch.Tensor:
    """[B, H, C, D] x [B, H, P, D] -> [B, C, P] f32 concept-by-patch similarity:
    the sum over heads of the per-head dot products equals the merged-head
    dot product."""
    return torch.einsum("bhcd,bhpd->bcp", concept_vectors.float(), image_vectors.float())
