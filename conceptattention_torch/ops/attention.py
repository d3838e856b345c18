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
two plain SDPA calls below, the reference the kernel is held against; "ring"
and "ring_rdma" split the fused sequence over the `seq` axis of `spec.mesh`
(sequence parallelism): "ring" is the plain ring of
`parallel/ring_attention.py`, "ring_rdma" the CUDA ring kernel (K4,
`kernels/ring_rdma.py`), which runs that plain ring for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

RING_BACKENDS = ("ring", "ring_rdma")


@dataclasses.dataclass(frozen=True)
class ConceptAttentionSpec:
    """Static configuration of the concept pass."""

    cross_attention: bool = True
    self_attention: bool = True
    # Which similarity taps to emit as per-layer saliency maps
    # ("output", "cross_attention", "value").
    taps: Tuple[str, ...] = ("output", "cross_attention")
    # Emit each double block's full vector sets (the merged-head attention
    # outputs and the pre-RoPE head-form q of concepts and image) in place
    # of the maps; large, for the concept basis.
    return_raw_vectors: bool = False
    # "fused" (one flash-saliency kernel launch), "sdpa" (two plain SDPAs),
    # "ring" (the plain sequence-parallel ring) or "ring_rdma" (the CUDA ring).
    backend: str = "fused"
    # Per-row int8 q and k with int8 x int8 -> int32 scores (the fused
    # backend's K1b); no other backend computes them.
    int8_qk: bool = False
    # Storage dtype of the per-step saliency stash: None keeps f32, "bf16"
    # rounds only the stacked copy (similarities are computed in f32).
    stash_dtype: Optional[str] = None
    # Ring backends only: the `parallel.mesh.Mesh` to split the fused
    # sequence over and its sequence axis; batch_axis / head_axis split the
    # batch and the heads over two more axes of it, one ring per
    # (batch, head) slice (the dp x sp x tp ring).
    mesh: Optional[object] = None
    seq_axis: str = "seq"
    batch_axis: Optional[str] = None
    head_axis: Optional[str] = None


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
    if spec.backend in RING_BACKENDS:
        return _ring_joint_concept_attention(txt_qkv, img_qkv, concept_qkv, pe, concept_pe, spec)
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


def _ring_joint_concept_attention(txt_qkv, img_qkv, concept_qkv, pe, concept_pe, spec):
    """The ring backends: RoPE per segment, the fused [txt | img | concept |
    pad] sequence padded to a multiple of the ring size, split over
    `spec.seq_axis` of `spec.mesh` and attended as a ring. Same contract as
    the fused backend."""
    from conceptattention_torch.ops.rope import apply_rope

    if spec.mesh is None:
        raise ValueError(f"spec.backend={spec.backend!r} requires spec.mesh")
    if spec.backend == "ring":
        from conceptattention_torch.parallel.ring_attention import (
            make_ring_concept_attention as make_ring,
        )
    else:
        from conceptattention_torch.kernels.ring_rdma import (
            make_ring_concept_attention_rdma as make_ring,
        )
    n_seq = spec.mesh.shape[spec.seq_axis]

    txt_q, txt_k, txt_v = txt_qkv
    img_q, img_k, img_v = img_qkv
    t, p = txt_q.shape[2], img_q.shape[2]
    cos, sin = pe
    txt_q_r, txt_k_r = apply_rope(txt_q, txt_k, (cos[:, :, :t], sin[:, :, :t]))
    img_q_r, img_k_r = apply_rope(img_q, img_k, (cos[:, :, t:], sin[:, :, t:]))
    seqs = [(txt_q_r, txt_k_r, txt_v), (img_q_r, img_k_r, img_v)]
    c_real = 0
    if concept_qkv is not None:
        con_q, con_k, con_v = concept_qkv
        c_real = con_q.shape[2]
        ccos, csin = concept_pe
        con_q_r, con_k_r = apply_rope(con_q, con_k, (ccos[:, :, :c_real], csin[:, :, :c_real]))
        seqs.append((con_q_r, con_k_r, con_v))
    q, k, v = (torch.cat([seg[i] for seg in seqs], dim=2) for i in range(3))
    s = q.shape[2]
    pad = -(-s // n_seq) * n_seq - s
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))

    fn = make_ring(
        spec.mesh, spec.seq_axis, txt_len=t, img_len=p, concept_len=c_real,
        cross=spec.cross_attention, self_attention=spec.self_attention,
        batch_axis=spec.batch_axis, head_axis=spec.head_axis,
    )
    out = fn(q, k, v)

    txt_attn = merge_heads(out[:, :, :t])
    img_out_h = out[:, :, t : t + p]
    img_attn = merge_heads(img_out_h)
    if concept_qkv is None:
        return txt_attn, img_attn, None, {}
    if not spec.cross_attention and not spec.self_attention:
        concept_out_h = concept_qkv[2]  # "neither" ablation: the values pass through
    else:
        concept_out_h = out[:, :, t + p : t + p + c_real]
    extras = {
        "concept_q": concept_qkv[0],
        "concept_k": concept_qkv[1],
        "img_q": img_q,
        "concept_v": concept_qkv[2],
        "img_v": img_v,
        "concept_out_h": concept_out_h,
        "img_out_h": img_out_h,
    }
    return txt_attn, img_attn, merge_heads(concept_out_h), extras


def similarity_map(concept_vectors: torch.Tensor, image_vectors: torch.Tensor) -> torch.Tensor:
    """[B, C, D] x [B, P, D] (heads merged) -> [B, C, P] f32 concept-by-patch
    similarity."""
    return torch.einsum("bcd,bpd->bcp", concept_vectors.float(), image_vectors.float())


def similarity_map_heads(concept_vectors: torch.Tensor, image_vectors: torch.Tensor) -> torch.Tensor:
    """[B, H, C, D] x [B, H, P, D] -> [B, C, P] f32 concept-by-patch similarity:
    the sum over heads of the per-head dot products equals the merged-head
    dot product."""
    return torch.einsum("bhcd,bhpd->bcp", concept_vectors.float(), image_vectors.float())
