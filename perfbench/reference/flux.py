"""Flux DiT with the concept stream, and the rectified-flow Euler loop, in
plain float32.

Follows the published Flux architecture (black-forest-labs/flux,
`model.py` and `modules/layers.py`) and ConceptAttention's concept stream:
concepts take the text stream's weights with their own modulation vector,
concept queries attend over [concept; image] keys under their own softmax,
and the image and text streams are computed as if concepts were absent.
Each double block emits two concept-by-patch maps summed over heads:
"output" (concept attention outputs x image attention outputs) and
"cross_attention" (concept queries x image queries, before RoPE).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    attention,
    flux_timestep_embedding,
    layer_norm,
    layer_of,
    linear,
    merge_heads,
    mlp_embedder,
    rms_norm,
    rope,
    rope_tables,
)


def _mod(vec: torch.Tensor, p, n: int) -> List[torch.Tensor]:
    """silu(vec) @ w + b in n chunks of [B, 1, D]."""
    return [c[:, None] for c in linear(F.silu(vec), p).chunk(n, dim=-1)]


def _qkv(x: torch.Tensor, p_qkv, qnorm, knorm, num_heads: int):
    h = linear(x, p_qkv)
    b, l, _ = h.shape
    q, k, v = h.reshape(b, l, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    return rms_norm(q, qnorm), rms_norm(k, knorm), v


def _mlp(x, p_in, p_out):
    return linear(F.gelu(linear(x, p_in), approximate="tanh"), p_out)


def double_block(p, img, txt, vec, pe, num_heads, concepts, cvec, cpe):
    """One double-stream block; returns (img, txt, concepts, maps)."""
    cos, sin = pe
    t = txt.shape[1]
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod(vec, p["img_mod"], 6)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod(vec, p["txt_mod"], 6)
    img_q, img_k, img_v = _qkv((1 + i_sc1) * layer_norm(img) + i_sh1, p["img_qkv"],
                               p["img_qnorm"], p["img_knorm"], num_heads)
    txt_q, txt_k, txt_v = _qkv((1 + t_sc1) * layer_norm(txt) + t_sh1, p["txt_qkv"],
                               p["txt_qnorm"], p["txt_knorm"], num_heads)
    img_c, img_s = cos[:, :, t:], sin[:, :, t:]
    q = torch.cat([rope(txt_q, cos[:, :, :t], sin[:, :, :t]), rope(img_q, img_c, img_s)], dim=2)
    k = torch.cat([rope(txt_k, cos[:, :, :t], sin[:, :, :t]), rope(img_k, img_c, img_s)], dim=2)
    out = attention(q, k, torch.cat([txt_v, img_v], dim=2))
    img_out_h = out[:, :, t:]

    maps = {}
    if concepts is not None:
        c = concepts.shape[1]
        c_sh1, c_sc1, c_g1, c_sh2, c_sc2, c_g2 = _mod(cvec, p["txt_mod"], 6)
        con_q, con_k, con_v = _qkv((1 + c_sc1) * layer_norm(concepts) + c_sh1, p["txt_qkv"],
                                   p["txt_qnorm"], p["txt_knorm"], num_heads)
        ccos, csin = cpe
        con_q_r = rope(con_q, ccos[:, :, :c], csin[:, :, :c])
        con_k_r = rope(con_k, ccos[:, :, :c], csin[:, :, :c])
        con_out_h = attention(con_q_r, torch.cat([con_k_r, k[:, :, t:]], dim=2),
                              torch.cat([con_v, img_v], dim=2))
        maps["output"] = torch.einsum("bhcd,bhpd->bcp", con_out_h, img_out_h)
        maps["cross_attention"] = torch.einsum("bhcd,bhpd->bcp", con_q, img_q)
        concepts = concepts + c_g1 * linear(merge_heads(con_out_h), p["txt_proj"])
        concepts = concepts + c_g2 * _mlp((1 + c_sc2) * layer_norm(concepts) + c_sh2,
                                          p["txt_mlp_in"], p["txt_mlp_out"])

    img = img + i_g1 * linear(merge_heads(img_out_h), p["img_proj"])
    img = img + i_g2 * _mlp((1 + i_sc2) * layer_norm(img) + i_sh2,
                            p["img_mlp_in"], p["img_mlp_out"])
    txt = txt + t_g1 * linear(merge_heads(out[:, :, :t]), p["txt_proj"])
    txt = txt + t_g2 * _mlp((1 + t_sc2) * layer_norm(txt) + t_sh2,
                            p["txt_mlp_in"], p["txt_mlp_out"])
    return img, txt, concepts, maps


def single_block(p, x, vec, pe, num_heads):
    sh, sc, g = _mod(vec, p["mod"], 3)
    x_mod = (1 + sc) * layer_norm(x) + sh
    q, k, v = _qkv(x_mod, p["qkv"], p["qnorm"], p["knorm"], num_heads)
    cos, sin = pe
    attn = merge_heads(attention(rope(q, cos, sin), rope(k, cos, sin), v))
    out = linear(attn, p["proj"]) + linear(F.gelu(linear(x_mod, p["mlp_in"]), approximate="tanh"),
                                           p["mlp_out"])
    return x + g * out


def forward(params, cfg: Dict, img, img_ids, txt, txt_ids, t, y, concepts=None,
            concept_ids=None, concept_vec=None, stop_after_double: bool = False):
    """The DiT on float32 inputs: (pred [B, P, C] or None, {tap: [L, B, C, P]}).

    `cfg` holds num_heads, axes_dim, depth, depth_single; `t` is [B] in [0, 1]."""
    heads = cfg["num_heads"]
    top = {k: v for k, v in params.items() if k not in ("double", "single")}
    vec = (mlp_embedder(flux_timestep_embedding(t), top["time_in"])
           + mlp_embedder(y, top["vector_in"]))
    img = linear(img, top["img_in"])
    txt = linear(txt, top["txt_in"])
    pe = rope_tables(torch.cat([txt_ids, img_ids], dim=1), cfg["axes_dim"])
    cvec = cpe = None
    if concepts is not None:
        cvec = (mlp_embedder(flux_timestep_embedding(t), top["time_in"])
                + mlp_embedder(concept_vec, top["vector_in"]))
        concepts = linear(concepts, top["txt_in"])
        cpe = rope_tables(torch.cat([concept_ids, img_ids], dim=1), cfg["axes_dim"])
    per_layer = []
    for i in range(cfg["depth"]):
        img, txt, concepts, maps = double_block(layer_of(params["double"], i), img, txt, vec, pe,
                                                heads, concepts, cvec, cpe)
        per_layer.append(maps)
    maps = {k: torch.stack([m[k] for m in per_layer]) for k in per_layer[0]}
    if stop_after_double:
        return None, maps
    t_len = txt.shape[1]
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg["depth_single"]):
        x = single_block(layer_of(params["single"], i), x, vec, pe, heads)
    fin = top["final"]
    sh, sc = (c[:, None] for c in linear(F.silu(vec), fin["adaln"]).chunk(2, dim=-1))
    return linear((1 + sc) * layer_norm(x[:, t_len:]) + sh, fin["linear"]), maps


def img_ids(h_tokens: int, w_tokens: int, device) -> torch.Tensor:
    """(0, y, x) ids of the packed grid, [1, h*w, 3]."""
    ys, xs = torch.meshgrid(torch.arange(h_tokens, device=device, dtype=torch.float32),
                            torch.arange(w_tokens, device=device, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([torch.zeros_like(ys), ys, xs], dim=-1).reshape(1, -1, 3)


def pack(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] latents -> [B, (H/2)(W/2), C*4] tokens, (c, dy, dx) order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack(x: torch.Tensor, h_tokens: int, w_tokens: int) -> torch.Tensor:
    b, _, cd = x.shape
    c = cd // 4
    x = x.reshape(b, h_tokens, w_tokens, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h_tokens * 2, w_tokens * 2)


def heatmaps(maps: torch.Tensor, layer_indices: Sequence[int], grid) -> torch.Tensor:
    """[T, L, B, C, P] maps -> [B, C, h, w]: softmax over concepts, the mean
    over the steps and the selected layers."""
    m = torch.softmax(maps, dim=-2)[:, list(layer_indices)].mean(dim=(0, 1))
    return m.reshape(m.shape[0], m.shape[1], *grid)


def generate(params, cfg: Dict, noise: torch.Tensor, txt, vec, concepts,
             schedule: Sequence[float], layer_indices: Sequence[int]):
    """The Euler loop from `noise` [1, C, H', W'] over `schedule` (steps + 1
    values, 1 -> 0), one image: (latents [1, P, C*4], concept heatmaps,
    cross-attention heatmaps), each [1, C, h, w]."""
    dev = noise.device
    _, _, lh, lw = noise.shape
    grid = (lh // 2, lw // 2)
    ids = img_ids(*grid, dev)
    t_ids = torch.zeros((1, txt.shape[1], 3), device=dev)
    c_ids = torch.zeros((1, concepts.shape[1], 3), device=dev)
    c_vec = torch.zeros_like(vec)
    x = pack(noise.float())
    steps = {"output": [], "cross_attention": []}
    for t_curr, t_prev in zip(schedule[:-1], schedule[1:]):
        t = torch.full((1,), t_curr, dtype=torch.float32, device=dev)
        pred, maps = forward(params, cfg, x, ids, txt, t_ids, t, vec, concepts, c_ids, c_vec)
        x = x + (t_prev - t_curr) * pred
        for k in steps:
            steps[k].append(maps[k])
    out = {k: heatmaps(torch.stack(v), layer_indices, grid) for k, v in steps.items()}
    return x, out["output"], out["cross_attention"]


def encode_maps(params, cfg: Dict, z: torch.Tensor, noise: torch.Tensor, t: float, txt,
                concepts, layer_indices: Sequence[int], y: Optional[torch.Tensor] = None):
    """One image's concept maps from its latents `z` [1, C, H', W']: forward
    noising to `t`, one forward stopped after the double blocks, modulated by
    the zero concept vector. Returns (concept heatmaps, cross maps) [1, C, h, w]."""
    dev = z.device
    _, _, lh, lw = z.shape
    grid = (lh // 2, lw // 2)
    x = pack(t * noise.float() + (1.0 - t) * z)
    zeros = torch.zeros((1, cfg["vec_in_dim"]), device=dev) if y is None else y
    _, maps = forward(params, cfg, x, img_ids(*grid, dev), txt,
                      torch.zeros((1, txt.shape[1], 3), device=dev),
                      torch.full((1,), t, dtype=torch.float32, device=dev), zeros, concepts,
                      torch.zeros((1, concepts.shape[1], 3), device=dev), zeros,
                      stop_after_double=True)
    out = {k: heatmaps(v[None], layer_indices, grid) for k, v in maps.items()}
    return out["output"], out["cross_attention"]
