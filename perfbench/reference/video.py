"""CogVideoX DiT with the concept stream, and the DDIM loop with
classifier-free guidance, in plain float32.

Follows diffusers' `CogVideoXTransformer3DModel` (the 5B model: 3D RoPE,
no absolute positions) and `CogVideoXDDIMScheduler` (scaled-linear betas,
the SNR shift, zero terminal SNR, v-prediction), with ConceptAttention's
concept stream: concept tokens take the text projection and the encoder
branch of both LayerNormZeros, concept queries attend over [concept; video]
keys under their own softmax, and the concept FF's LayerNormZero sees the
updated concept states. The "output" map is concept attention outputs x
video attention outputs, summed over heads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    attention,
    gelu_tanh,
    layer_norm,
    layer_of,
    linear,
    merge_heads,
    rope,
    rope_tables,
)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' `get_timestep_embedding` (flip_sin_to_cos, shift 0) of raw timesteps."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _norm_zero(p, temb, hidden, other, eps):
    shift, scale, gate, o_shift, o_scale, o_gate = linear(F.silu(temb), p["lin"]).chunk(6, dim=-1)
    w, b = p["ln"]["w"], p["ln"]["b"]
    nh = layer_norm(hidden, w, b, eps) * (1 + scale[:, None]) + shift[:, None]
    no = layer_norm(other, w, b, eps) * (1 + o_scale[:, None]) + o_shift[:, None]
    return nh, no, gate[:, None], o_gate[:, None]


def _qkv(x, p, num_heads):
    h = linear(x, p["qkv"])
    b, l, _ = h.shape
    q, k, v = h.reshape(b, l, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    q = layer_norm(q, p["qnorm"]["w"], p["qnorm"]["b"], 1e-6)
    k = layer_norm(k, p["knorm"]["w"], p["knorm"]["b"], 1e-6)
    return q, k, v


def _ff(x, p):
    return linear(gelu_tanh(linear(x, p["ff_in"])), p["ff_out"])


def block(p, cfg: Dict, video, text, concepts, temb, pe, cpe):
    eps, nh = cfg["norm_eps"], cfg["num_heads"]
    t = text.shape[1]
    c = concepts.shape[1]
    n_video, n_text, v_gate, t_gate = _norm_zero(p["norm1"], temb, video, text, eps)
    _, n_con, _, c_gate = _norm_zero(p["norm1"], temb, video, concepts, eps)
    vq, vk, vv = _qkv(n_video, p, nh)
    tq, tk, tv = _qkv(n_text, p, nh)
    cq, ck, cv = _qkv(n_con, p, nh)
    cos, sin = pe
    vq_r, vk_r = rope(vq, cos[:, :, t:], sin[:, :, t:]), rope(vk, cos[:, :, t:], sin[:, :, t:])
    tq_r, tk_r = rope(tq, cos[:, :, :t], sin[:, :, :t]), rope(tk, cos[:, :, :t], sin[:, :, :t])
    out = attention(torch.cat([tq_r, vq_r], dim=2), torch.cat([tk_r, vk_r], dim=2),
                    torch.cat([tv, vv], dim=2))
    ccos, csin = cpe
    cq_r, ck_r = rope(cq, ccos[:, :, :c], csin[:, :, :c]), rope(ck, ccos[:, :, :c], csin[:, :, :c])
    con_out = attention(cq_r, torch.cat([ck_r, vk_r], dim=2), torch.cat([cv, vv], dim=2))
    video_out = out[:, :, t:]
    maps = torch.einsum("bhcd,bhpd->bcp", con_out, video_out)

    video = video + v_gate * linear(merge_heads(video_out), p["proj"])
    text = text + t_gate * linear(merge_heads(out[:, :, :t]), p["proj"])
    concepts = concepts + c_gate * linear(merge_heads(con_out), p["proj"])
    _, n_con, _, c_gate_ff = _norm_zero(p["norm2"], temb, video, concepts, eps)
    concepts = concepts + c_gate_ff * _ff(n_con, p)
    n_video, n_text, v_gate_ff, t_gate_ff = _norm_zero(p["norm2"], temb, video, text, eps)
    ff = _ff(torch.cat([n_text, n_video], dim=1), p)
    return video + v_gate_ff * ff[:, t:], text + t_gate_ff * ff[:, :t], concepts, maps


def _patchify(video: torch.Tensor, p: int) -> torch.Tensor:
    b, f, c, h, w = video.shape
    x = video.reshape(b, f, c, h // p, p, w // p, p).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, f * (h // p) * (w // p), c * p * p)


def _unpatchify(tokens, f, h, w, c, p):
    b = tokens.shape[0]
    x = tokens.reshape(b, f, h // p, w // p, c, p, p).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, f, c, h, w)


def forward(params, cfg: Dict, video, text, timestep, concepts):
    """(pred [B, F, C, H, W], output maps [L, B, C_slots, F*P]) in float32."""
    b, f, _, h, w = video.shape
    p = cfg["patch_size"]
    dev = video.device
    top = {k: v for k, v in params.items() if k != "blocks"}
    temb = linear(F.silu(linear(timestep_embedding(timestep, cfg["hidden"]), top["time_lin1"])),
                  top["time_lin2"])
    tokens = linear(_patchify(video, p), top["patch_proj"])
    text = linear(text, top["text_proj"])
    concepts = linear(concepts, top["text_proj"])
    fs, ys, xs = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=dev)
                                  for n in (f, h // p, w // p)), indexing="ij")
    vids = torch.stack([fs, ys, xs], dim=-1).reshape(1, -1, 3).expand(b, -1, -1)
    d = cfg["head_dim"]
    axes = (d // 4, 3 * d // 8, 3 * d // 8)
    pe = rope_tables(torch.cat([torch.zeros((b, text.shape[1], 3), device=dev), vids], 1), axes)
    cpe = rope_tables(torch.cat([torch.zeros((b, concepts.shape[1], 3), device=dev), vids], 1),
                      axes)
    maps: List[torch.Tensor] = []
    for i in range(cfg["num_layers"]):
        tokens, text, concepts, m = block(layer_of(params["blocks"], i), cfg, tokens, text,
                                          concepts, temb, pe, cpe)
        maps.append(m)
    eps = cfg["norm_eps"]
    tokens = layer_norm(tokens, top["norm_final"]["w"].float(), top["norm_final"]["b"].float(),
                        eps)
    shift, scale = linear(F.silu(temb), top["norm_out_lin"]).chunk(2, dim=-1)
    tokens = layer_norm(tokens, top["norm_out_ln"]["w"].float(), top["norm_out_ln"]["b"].float(),
                        eps) * (1 + scale[:, None]) + shift[:, None]
    tokens = linear(tokens, top["proj_out"])
    return _unpatchify(tokens, f, h, w, cfg["out_channels"], p), torch.stack(maps)


def ddim_alphas(steps: int, train_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012, snr_shift: float = 3.0):
    """(timesteps, alphas_cumprod float64): scaled-linear betas, the SNR
    shift, zero terminal SNR; `steps` evenly spaced timesteps, descending."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps) ** 2
    a = np.cumprod(1.0 - betas)
    a = a / (snr_shift + (1.0 - snr_shift) * a)
    s = np.sqrt(a)
    a = ((s - s[-1]) * (s[0] / (s[0] - s[-1]))) ** 2
    ratio = train_steps // steps
    return [int(x) for x in (np.arange(steps) * ratio)[::-1]], a


def generate(params, cfg: Dict, latents, text_cond, text_uncond, concepts, n_concepts: int,
             steps: int, guidance: float, layer_indices: Sequence[int]):
    """The CFG DDIM loop (v-prediction, eta 0) from `latents` [1, F, C, H, W]:
    (latents, heatmaps [C, F, h, w])."""
    timesteps, alphas = ddim_alphas(steps)
    gap = 1000 // steps
    text = torch.cat([text_uncond, text_cond])
    concepts2 = torch.cat([concepts, concepts])
    x = latents.float()
    _, f, _, h, w = x.shape
    p = cfg["patch_size"]
    per_step = []
    for t in timesteps:
        pred, maps = forward(params, cfg, torch.cat([x, x]), text,
                             torch.full((2,), float(t), device=x.device), concepts2)
        uncond, cond = pred.chunk(2)
        v = uncond + guidance * (cond - uncond)
        sel = maps[list(layer_indices), -1]
        per_step.append(torch.softmax(sel, dim=-2)[:, :n_concepts].mean(dim=0))
        a_t = float(alphas[t])
        a_prev = float(alphas[t - gap]) if t - gap >= 0 else 1.0
        x0 = math.sqrt(a_t) * x - math.sqrt(1 - a_t) * v
        eps = math.sqrt(a_t) * v + math.sqrt(1 - a_t) * x
        x = math.sqrt(a_prev) * x0 + math.sqrt(1 - a_prev) * eps
    maps = torch.stack(per_step).mean(dim=0)
    return x, maps.reshape(n_concepts, f, h // p, w // p)
