"""HunyuanVideo with the concept stream, and its flow-matching Euler loop, in
plain float32, one clip (B=1).

Follows the published model (tencent/HunyuanVideo `hyvideo/modules/`:
`models.py`, `token_refiner.py`, `posemb_layers.py`; diffusers'
`HunyuanVideoTransformer3DModel`): the token refiner over the full text
slots with the boolean mask, dual-stream blocks over [video; text] and
single-stream blocks over the same, each attention split by the mask as
`cu_seqlens` splits it (the video and the valid text attend among
themselves, the padded text among itself; in the refiner a padded query
attends to slot 0 alone), 3-axis RoPE on the video tokens only at theta
256, embedded guidance, the final adaLN layer, and the scheduler's shifted
sigmas 7s / (1 + 6s) with the Euler update x + (s' - s) v.

Departures from the published model, all of the concept stream (this
repository's extension; the paper's is on Flux): each concept is the first
text state of its own encoding; the concepts go through the refiner as a
sequence of their own, unmasked; they are unrotated (ids 0, as the text's
identity rotation); they take the text stream's weights with the
conditioning vector of a zero pooled input; concept queries attend over
[concept; video] keys under their own softmax, and the video and text are
computed as if concepts were absent. Each dual-stream block emits two
concept-by-patch maps summed over heads: "output" (concept attention
outputs x video attention outputs) and "cross_attention" (concept queries x
video queries, before RoPE).

Imports Flux's modulation, projection and MLP pieces from `flux.py`; the
blocks here differ from Flux's by the masked attention over [video; text].

Within `common.rounded` (the control) the attention outputs are rounded
too, as the program stores them (bf16 out of its attention kernel): with
random weights each concept's queries spread over 67k video keys, the four
concepts' outputs differ by a small part of their common mean, and the
heatmaps, a softmax over the concepts of those outputs' products with the
video's, turn on that part. The float32 reference is unchanged by it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    attention,
    operands,
    flux_timestep_embedding,
    layer_norm,
    layer_of,
    linear,
    merge_heads,
    mlp_embedder,
    rope,
    rope_tables,
)
from perfbench.reference.flux import _mlp, _mod, _qkv, pack, unpack

Parts = List[Tuple[torch.Tensor, torch.Tensor]]


def stored(x: torch.Tensor) -> torch.Tensor:
    """An attention output as the scope's rounding leaves it (`common.rounded`)."""
    return operands(x, x)[0]


def masked_attention(q, k, v, parts: Parts) -> torch.Tensor:
    """Attention over [1, H, L, D] split by `parts`: each (queries, keys)
    pair of index tensors attends its queries over its keys alone; every
    query lies in one pair."""
    out = torch.empty_like(q)
    for qi, ki in parts:
        out[:, :, qi] = attention(q[:, :, qi], k[:, :, ki], v[:, :, ki])
    return stored(out)


def token_refiner(p, cfg: Dict, x: torch.Tensor, t: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """`SingleTokenRefiner` on [1, T, text_dim] states with the valid slots
    `mask` [T] bool, at flow time t [1] in [0, 1]: -> [1, T, hidden]."""
    heads = cfg["num_heads"]
    m = mask.float()[None, :, None]
    c = (mlp_embedder(flux_timestep_embedding(t), p["t_embedder"])
         + mlp_embedder((x * m).sum(dim=1) / m.sum(dim=1), p["c_embedder"]))
    x = linear(x, p["input_embedder"])
    valid, pad = mask.nonzero()[:, 0], (~mask).nonzero()[:, 0]
    parts = [(valid, valid)] + ([(pad, torch.zeros_like(pad[:1]))] if len(pad) else [])
    b, n, _ = x.shape
    for i in range(cfg["num_refiner_layers"]):
        lp = layer_of(p["blocks"], i)
        gate_msa, gate_mlp = (g[:, None] for g in linear(F.silu(c), lp["adaln"]).chunk(2, dim=-1))
        h = layer_norm(x, lp["norm1"]["w"], lp["norm1"]["b"])
        q, k, v = linear(h, lp["qkv"]).reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
        x = x + gate_msa * linear(merge_heads(masked_attention(q, k, v, parts)), lp["proj"])
        h = layer_norm(x, lp["norm2"]["w"], lp["norm2"]["b"])
        x = x + gate_mlp * linear(F.silu(linear(h, lp["mlp_in"])), lp["mlp_out"])
    return x


def double_block(p, img, txt, vec, pe, heads: int, parts: Parts, concepts, cvec):
    """One dual-stream block over [video; text]; returns (img, txt, concepts, maps)."""
    cos, sin = pe
    n_img = img.shape[1]
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod(vec, p["img_mod"], 6)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod(vec, p["txt_mod"], 6)
    img_q, img_k, img_v = _qkv((1 + i_sc1) * layer_norm(img) + i_sh1, p["img_qkv"],
                               p["img_qnorm"], p["img_knorm"], heads)
    txt_q, txt_k, txt_v = _qkv((1 + t_sc1) * layer_norm(txt) + t_sh1, p["txt_qkv"],
                               p["txt_qnorm"], p["txt_knorm"], heads)
    img_k_r = rope(img_k, cos, sin)
    out = masked_attention(torch.cat([rope(img_q, cos, sin), txt_q], dim=2),
                           torch.cat([img_k_r, txt_k], dim=2), torch.cat([img_v, txt_v], dim=2),
                           parts)
    img_out = out[:, :, :n_img]
    maps = {}
    if concepts is not None:
        c_sh1, c_sc1, c_g1, c_sh2, c_sc2, c_g2 = _mod(cvec, p["txt_mod"], 6)
        con_q, con_k, con_v = _qkv((1 + c_sc1) * layer_norm(concepts) + c_sh1, p["txt_qkv"],
                                   p["txt_qnorm"], p["txt_knorm"], heads)
        con_out = stored(attention(con_q, torch.cat([con_k, img_k_r], dim=2),
                                   torch.cat([con_v, img_v], dim=2)))
        maps["output"] = torch.einsum("bhcd,bhpd->bcp", con_out, img_out)
        maps["cross_attention"] = torch.einsum("bhcd,bhpd->bcp", con_q, img_q)
        concepts = concepts + c_g1 * linear(merge_heads(con_out), p["txt_proj"])
        concepts = concepts + c_g2 * _mlp((1 + c_sc2) * layer_norm(concepts) + c_sh2,
                                          p["txt_mlp_in"], p["txt_mlp_out"])
    img = img + i_g1 * linear(merge_heads(img_out), p["img_proj"])
    img = img + i_g2 * _mlp((1 + i_sc2) * layer_norm(img) + i_sh2,
                            p["img_mlp_in"], p["img_mlp_out"])
    txt = txt + t_g1 * linear(merge_heads(out[:, :, n_img:]), p["txt_proj"])
    txt = txt + t_g2 * _mlp((1 + t_sc2) * layer_norm(txt) + t_sh2,
                            p["txt_mlp_in"], p["txt_mlp_out"])
    return img, txt, concepts, maps


def single_block(p, x, vec, pe, heads: int, parts: Parts, n_img: int):
    """One single-stream block over [video; text]: linear1 to qkv and the MLP,
    linear2 on [attention; gelu(mlp)], one gate."""
    sh, sc, g = _mod(vec, p["mod"], 3)
    x_mod = (1 + sc) * layer_norm(x) + sh
    q, k, v = _qkv(x_mod, p["qkv"], p["qnorm"], p["knorm"], heads)
    cos, sin = pe
    q = torch.cat([rope(q[:, :, :n_img], cos, sin), q[:, :, n_img:]], dim=2)
    k = torch.cat([rope(k[:, :, :n_img], cos, sin), k[:, :, n_img:]], dim=2)
    attn = merge_heads(masked_attention(q, k, v, parts))
    out = linear(attn, p["proj"]) + linear(F.gelu(linear(x_mod, p["mlp_in"]), approximate="tanh"),
                                           p["mlp_out"])
    return x + g * out


def video_ids(frames: int, h_tokens: int, w_tokens: int, device) -> torch.Tensor:
    """(t, y, x) ids of the patch grid, frame-major, [1, F*h*w, 3]."""
    grid = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=device)
                            for n in (frames, h_tokens, w_tokens)), indexing="ij")
    return torch.stack(grid, dim=-1).reshape(1, -1, 3)


def patchify(video: torch.Tensor) -> torch.Tensor:
    """[1, F, C, H, W] -> [1, F*(H/2)*(W/2), C*4]: each frame's 2x2 patches,
    channel-outer (the Conv3d patch embedding's (c, 1, 2, 2) kernel order)."""
    _, f, c, h, w = video.shape
    return pack(video[0]).reshape(1, f * (h // 2) * (w // 2), c * 4)


def forward(params, cfg: Dict, video, txt, mask, t, y, guidance, concepts=None):
    """The transformer on float32 inputs: video [1, F, C, H, W], text
    [1, T, text_dim] with valid slots `mask` [T], t and guidance [1], pooled
    y [1, pooled_dim], concepts [1, C, text_dim] or None.
    Returns (velocity [1, F, C, H, W], {tap: [L, 1, C, F*P]}).

    `cfg`: num_heads, axes_dim, theta, depth, depth_single, num_refiner_layers."""
    _, f, _, h, w = video.shape
    dev = video.device
    heads = cfg["num_heads"]
    top = {k: v for k, v in params.items() if k not in ("double", "single")}

    def cond(pooled):
        return (mlp_embedder(flux_timestep_embedding(t), top["time_in"])
                + mlp_embedder(flux_timestep_embedding(guidance), top["guidance_in"])
                + mlp_embedder(pooled, top["vector_in"]))

    vec = cond(y)
    img = linear(patchify(video), top["img_in"])
    n_img = img.shape[1]
    txt = token_refiner(top["refiner"], cfg, txt, t, mask)
    cvec = None
    if concepts is not None:
        cvec = cond(torch.zeros_like(y))
        concepts = token_refiner(top["refiner"], cfg, concepts, t,
                                 torch.ones(concepts.shape[1], dtype=torch.bool, device=dev))
    pe = rope_tables(video_ids(f, h // 2, w // 2, dev), cfg["axes_dim"], cfg["theta"])
    valid = torch.cat([torch.arange(n_img, device=dev), n_img + mask.nonzero()[:, 0]])
    pad = n_img + (~mask).nonzero()[:, 0]
    parts = [(valid, valid)] + ([(pad, pad)] if len(pad) else [])
    per_layer = []
    for i in range(cfg["depth"]):
        img, txt, concepts, maps = double_block(layer_of(params["double"], i), img, txt, vec, pe,
                                                heads, parts, concepts, cvec)
        per_layer.append(maps)
    maps = ({k: torch.stack([m[k] for m in per_layer]) for k in per_layer[0]}
            if concepts is not None else {})
    x = torch.cat([img, txt], dim=1)
    for i in range(cfg["depth_single"]):
        x = single_block(layer_of(params["single"], i), x, vec, pe, heads, parts, n_img)
    fin = top["final"]
    sh, sc = (c[:, None] for c in linear(F.silu(vec), fin["adaln"]).chunk(2, dim=-1))
    tokens = linear((1 + sc) * layer_norm(x[:, :n_img]) + sh, fin["linear"])
    frames = unpack(tokens.reshape(f, (h // 2) * (w // 2), -1), h // 2, w // 2)
    return frames[None], maps


def sigmas(steps: int, shift: float) -> List[float]:
    """The scheduler's sigmas: linspace(1, 0, steps + 1), each shifted to
    shift s / (1 + (shift - 1) s)."""
    return [shift * s / (1.0 + (shift - 1.0) * s)
            for s in (1.0 - i / steps for i in range(steps + 1))]


def generate(params, cfg: Dict, latents, txt, mask, y, concepts, steps: int, shift: float,
             guidance: float, layer_indices: Sequence[int]):
    """The Euler loop from `latents` [1, F, C, H, W]: (latents, heatmaps
    [C, F, h, w]: each step's "output" maps, softmax over the concepts and
    the mean over the selected layers, then the mean over the steps)."""
    dev = latents.device
    _, f, _, h, w = latents.shape
    x = latents.float()
    g = torch.full((1,), guidance, dtype=torch.float32, device=dev)
    per_step = []
    sched = sigmas(steps, shift)
    for s, s_next in zip(sched[:-1], sched[1:]):
        v, maps = forward(params, cfg, x, txt, mask, torch.full((1,), s, device=dev), y, g,
                          concepts)
        x = x + (s_next - s) * v
        per_step.append(torch.softmax(maps["output"][list(layer_indices), 0], dim=-2).mean(dim=0))
    heat = torch.stack(per_step).mean(dim=0)
    return x, heat.reshape(heat.shape[0], f, h // 2, w // 2)

