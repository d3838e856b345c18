"""CogVideoX video DiT with a concept-token stream.

Counterpart of the JAX package's `models/video/dit.py`. The blocks hand
`spec` to `joint_concept_attention` as it is, so the ring backends
("ring", "ring_rdma" over `spec.mesh`) split each block's fused sequence
over the ring as in the flux double blocks. The diffusers
`CogVideoXTransformer3DModel` layout:

  - per-frame 2x2 patchify of the video latents as one linear, and a text
    projection that the concepts share (so the 2B variant's absolute
    positional embeddings give concepts the text slots' embeddings);
  - `CogVideoXLayerNormZero` blocks: one affine LayerNorm and a
    `silu(temb) @ W` giving six chunks (shift/scale/gate for the video
    stream and for the text-or-concept stream);
  - per-head LayerNorm q/k normalization (eps 1e-6, affine);
  - 3D RoPE on the video segment only (text and concept tokens sit at
    position 0, the identity rotation), axes (t, h, w) = head_dim *
    (2/8, 3/8, 3/8), interleaved pairs; the 2B variant zeroes every id;
  - taps: `output` = concept outputs x image outputs (merged heads);
    `cross_attention` = roped image queries x unroped concept keys, mean over
    heads;
  - `norm_final` -> AdaLayerNorm (shift then scale) -> `proj_out` -> unpatchify.

Per-layer parameters are stacked along a leading depth axis, as the JAX
package stacks them for its scan, so a numpy tree from JAX converts leaf by
leaf (`weights/from_jax.py`); the forward is a Python loop over layers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.kernels.layer_norm import layer_norm, qk_layer_norm
from conceptattention_torch.models.flux.blocks import _linear
from conceptattention_torch.models.flux.params import Params, _Init, layer
from conceptattention_torch.ops.attention import (
    ConceptAttentionSpec,
    joint_concept_attention,
    similarity_map_heads,
)
from conceptattention_torch.ops.rope import apply_rope, embed_nd
from conceptattention_torch.utils.profiling import DIT_FORWARD, span


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    """`CogVideoXTransformer3DModel.__init__` defaults (the 2B model);
    `cogvideox_5b_config` gives the 5B one."""

    num_attention_heads: int = 30
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 30
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    patch_size: int = 2
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_hidden_dim(self) -> int:
        return 4 * self.hidden_size

    @property
    def rope_axes_dim(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        return (d // 4, 3 * d // 8, 3 * d // 8)


def cogvideox_5b_config(**overrides) -> CogVideoXConfig:
    """CogVideoX-5b: 48 heads of 64 (hidden 3072), 42 layers, 3D RoPE."""
    base = dict(num_attention_heads=48, num_layers=42, use_rotary_positional_embeddings=True)
    base.update(overrides)
    return CogVideoXConfig(**base)


def make_video_ids(
    frames: int, h_tokens: int, w_tokens: int, batch_size: int = 1, device=None
) -> torch.Tensor:
    """(frame, y, x) id triples -> [B, F*h*w, 3] f32, frame-major."""
    f, y, x = torch.meshgrid(
        torch.arange(frames, dtype=torch.float32, device=device),
        torch.arange(h_tokens, dtype=torch.float32, device=device),
        torch.arange(w_tokens, dtype=torch.float32, device=device),
        indexing="ij",
    )
    ids = torch.stack([f, y, x], dim=-1).reshape(1, -1, 3)
    return ids.expand(batch_size, -1, -1)


def _timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                        freq_shift: int, max_period: float = 10_000.0) -> torch.Tensor:
    """diffusers `get_timestep_embedding` in f32: t is the RAW scheduler
    timestep (0..999), not flux's 0..1."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - freq_shift)
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def _sincos_pos_embed_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[...] positions -> [L, dim] as [sin | cos]."""
    omega = 1.0 / (10_000.0 ** (torch.arange(dim // 2, dtype=torch.float32) / (dim / 2.0)))
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def cogvideox_pos_embedding(cfg: CogVideoXConfig) -> torch.Tensor:
    """The 2B variant's absolute sincos positional embedding,
    [1, max_text_seq_length + T_video, hidden] f32 with zero text slots.

    diffusers' quirk is kept for checkpoint parity: the grid is
    meshgrid(grid_w, grid_h), so the FIRST spatial half embeds the w
    coordinate (visible on the non-square 45x30 grid)."""
    d, p = cfg.hidden_size, cfg.patch_size
    h, w = cfg.sample_height // p, cfg.sample_width // p
    f = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
    d_s, d_t = d // 4 * 3, d // 4
    gh = torch.arange(h, dtype=torch.float32) / cfg.spatial_interpolation_scale
    gw = torch.arange(w, dtype=torch.float32) / cfg.spatial_interpolation_scale
    gt = torch.arange(f, dtype=torch.float32) / cfg.temporal_interpolation_scale
    wg, hg = torch.meshgrid(gw, gh, indexing="xy")  # each [h, w]
    spatial = torch.cat(
        [_sincos_pos_embed_1d(d_s // 2, wg), _sincos_pos_embed_1d(d_s // 2, hg)], dim=-1
    )
    temporal = _sincos_pos_embed_1d(d_t, gt)
    joint = torch.cat(
        [temporal[:, None].expand(f, h * w, d_t), spatial[None].expand(f, h * w, d_s)], dim=-1
    ).reshape(1, f * h * w, d)
    return torch.cat([torch.zeros(1, cfg.max_text_seq_length, d), joint], dim=1)


def patchify_latents(video: torch.Tensor, patch: int = 2) -> torch.Tensor:
    """[B, F, C, H, W] -> [B, F*(H/p)*(W/p), C*p*p], (c, dy, dx) element order."""
    b, f, c, h, w = video.shape
    x = video.reshape(b, f, c, h // patch, patch, w // patch, patch)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)  # [B, F, h, w, C, p, p]
    return x.reshape(b, f * (h // patch) * (w // patch), c * patch * patch)


def unpatchify_latents(
    tokens: torch.Tensor, frames: int, h: int, w: int, out_channels: int, patch: int = 2
) -> torch.Tensor:
    """[B, F*h*w/p^2, C*p*p] -> [B, F, C, H, W]."""
    b = tokens.shape[0]
    x = tokens.reshape(b, frames, h // patch, w // patch, out_channels, patch, patch)
    x = x.permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, frames, out_channels, h, w)


def _norm_zero(p: Params, temb: torch.Tensor, hidden: Optional[torch.Tensor],
               other: torch.Tensor, eps: float):
    """CogVideoXLayerNormZero: affine LN + six-chunk AdaLN from temb.
    Returns (norm_hidden, norm_other, gate, other_gate); with `hidden` None
    only the other stream is normalised (norm_hidden is None)."""
    mod = _linear(F.silu(temb), p["lin"])
    shift, scale, gate, o_shift, o_scale, o_gate = mod.chunk(6, dim=-1)
    w, b = p["ln"]["w"], p["ln"]["b"]
    nh = None if hidden is None else layer_norm(hidden, w, b, eps, scale=scale, shift=shift)
    no = layer_norm(other, w, b, eps, scale=o_scale, shift=o_shift)
    return nh, no, gate[:, None], o_gate[:, None]


def _qkv_heads_ln(x: torch.Tensor, qkv: Params, qnorm: Params, knorm: Params, num_heads: int):
    """Fused qkv projection ([D, 3*H*hd], laid out (3, H, hd)) and per-head
    affine LayerNorm of q and k (eps 1e-6). Returns [B, H, L, hd] each."""
    h = _linear(x, qkv)
    q, k = qk_layer_norm(h, num_heads, qnorm["w"], qnorm["b"], knorm["w"], knorm["b"], eps=1e-6)
    b, l, _ = h.shape
    return q, k, h.reshape(b, l, 3, num_heads, -1).permute(2, 0, 3, 1, 4)[2]


def _feed_forward(x: torch.Tensor, p: Params) -> torch.Tensor:
    return _linear(F.gelu(_linear(x, p["ff_in"]), approximate="tanh"), p["ff_out"])


def _video_block(
    p: Params,
    cfg: CogVideoXConfig,
    video: torch.Tensor,
    text: torch.Tensor,
    concepts: Optional[torch.Tensor],
    temb: torch.Tensor,
    pe,
    concept_pe,
    spec: ConceptAttentionSpec,
):
    """One CogVideoX block with the concept stream: shared attention and FF
    weights across the streams; concepts ride the encoder branch of both
    LayerNormZeros, conditioned on the video hidden states. Returns
    (video, text, concepts, saliency {tap: [B, C, P] f32})."""
    n_video, n_text, v_gate, t_gate = _norm_zero(p["norm1"], temb, video, text, cfg.norm_eps)
    heads = cfg.num_attention_heads
    video_qkv = _qkv_heads_ln(n_video, p["qkv"], p["qnorm"], p["knorm"], heads)
    text_qkv = _qkv_heads_ln(n_text, p["qkv"], p["qnorm"], p["knorm"], heads)

    concept_qkv = c_gate = None
    if concepts is not None:
        _, n_con, _, c_gate = _norm_zero(p["norm1"], temb, None, concepts, cfg.norm_eps)
        concept_qkv = _qkv_heads_ln(n_con, p["qkv"], p["qnorm"], p["knorm"], heads)

    text_attn, video_attn, concept_attn, extras = joint_concept_attention(
        text_qkv, video_qkv, concept_qkv, pe, concept_pe, spec
    )

    saliency: Dict[str, torch.Tensor] = {}
    if concepts is not None:
        if "output" in spec.taps:
            saliency["output"] = similarity_map_heads(extras["concept_out_h"], extras["img_out_h"])
        if "cross_attention" in spec.taps:
            t_len = text.shape[1]
            cos, sin = pe
            img_q_r, _ = apply_rope(extras["img_q"], extras["img_q"],
                                    (cos[:, :, t_len:], sin[:, :, t_len:]))
            saliency["cross_attention"] = torch.einsum(
                "bhpd,bhcd->bcp", img_q_r.float(), extras["concept_k"].float()
            ) / heads

    video = video + v_gate * _linear(video_attn, p["proj"])
    text = text + t_gate * _linear(text_attn, p["proj"])
    if concepts is not None:
        concepts = concepts + c_gate * _linear(concept_attn, p["proj"])
        # The concept branch takes only the concept stream's half of each
        # LayerNormZero: the video stream's half is the video branch's own.
        _, n_con, _, c_gate_ff = _norm_zero(p["norm2"], temb, None, concepts, cfg.norm_eps)
        concepts = concepts + c_gate_ff * _feed_forward(n_con, p)

    n_video, n_text, v_gate_ff, t_gate_ff = _norm_zero(p["norm2"], temb, video, text, cfg.norm_eps)
    t_len = text.shape[1]
    ff = _feed_forward(torch.cat([n_text, n_video], dim=1), p)
    video = video + v_gate_ff * ff[:, t_len:]
    text = text + t_gate_ff * ff[:, :t_len]
    return video, text, concepts, saliency


def video_dit_forward(
    params: Params,
    cfg: CogVideoXConfig,
    video: torch.Tensor,
    text: torch.Tensor,
    timestep: torch.Tensor,
    concepts: Optional[torch.Tensor] = None,
    video_ids: Optional[torch.Tensor] = None,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the CogVideoX DiT.

    Args:
      video: [B, F, C, H, W] latents (before patchify).
      text: [B, T, text_embed_dim] T5 states.
      timestep: [B] RAW scheduler timesteps (0..999).
      concepts: [B, C_tokens, text_embed_dim] concept embeddings, or None.
      video_ids: optional [B, F*P, 3] rope ids (default: the native grid).

    Returns (pred [B, F, C_out, H, W], saliency {tap: [depth, B, C, F*P] f32},
    empty without concepts).
    """
    with span(DIT_FORWARD):
        b, f, _, h, w = video.shape
        p = cfg.patch_size
        t_len = text.shape[1]
        dev = video.device

        temb = _timestep_embedding(timestep, cfg.hidden_size, cfg.flip_sin_to_cos,
                                   cfg.freq_shift).to(video.dtype)
        temb = _linear(F.silu(_linear(temb, params["time_lin1"])), params["time_lin2"])

        tokens = _linear(patchify_latents(video, p), params["patch_proj"])
        text = _linear(text, params["text_proj"])
        has_concepts = concepts is not None
        if has_concepts:
            concepts = _linear(concepts, params["text_proj"])

        if not cfg.use_rotary_positional_embeddings:
            pos = cogvideox_pos_embedding(cfg).to(dev, tokens.dtype)
            t0 = cfg.max_text_seq_length
            tokens = tokens + pos[:, t0 : t0 + tokens.shape[1]]
            text = text + pos[:, :t_len]
            if has_concepts:
                concepts = concepts + pos[:, : concepts.shape[1]]

        if video_ids is None:
            video_ids = make_video_ids(f, h // p, w // p, batch_size=b, device=dev)
        if not cfg.use_rotary_positional_embeddings:
            # No RoPE in the 2B model: zero ids make the rotation the identity, so
            # one code path serves both variants.
            video_ids = torch.zeros_like(video_ids)
        axes, theta = cfg.rope_axes_dim, 10_000
        text_ids = torch.zeros((b, t_len, 3), dtype=torch.float32, device=dev)
        pe = embed_nd(torch.cat([text_ids, video_ids], dim=1), axes, theta)
        concept_pe = None
        if has_concepts:
            concept_ids = torch.zeros((b, concepts.shape[1], 3), dtype=torch.float32, device=dev)
            concept_pe = embed_nd(torch.cat([concept_ids, video_ids], dim=1), axes, theta)

        per_layer = []
        for i in range(cfg.num_layers):
            tokens, text, concepts, saliency = _video_block(
                layer(params["blocks"], i), cfg, tokens, text, concepts, temb, pe, concept_pe, spec
            )
            per_layer.append(saliency)
        saliency = {k: torch.stack([s[k] for s in per_layer]) for k in per_layer[0]}

        tokens = layer_norm(tokens, params["norm_final"]["w"], params["norm_final"]["b"],
                            cfg.norm_eps)
        mod = _linear(F.silu(temb), params["norm_out_lin"])
        shift, scale = mod.chunk(2, dim=-1)
        tokens = layer_norm(tokens, params["norm_out_ln"]["w"], params["norm_out_ln"]["b"],
                            cfg.norm_eps, scale=scale, shift=shift)
        tokens = _linear(tokens, params["proj_out"])
        return unpatchify_latents(tokens, f, h, w, cfg.out_channels, p), saliency


def init_video_dit_params(
    generator: torch.Generator, cfg: CogVideoXConfig, dtype: torch.dtype = torch.bfloat16
) -> Params:
    """Randomly initialized CogVideoX DiT parameters on the generator's
    device, with the JAX package's distributions (weights N(0, 1/in),
    zero biases, unit norm scales) and layout (blocks stacked by depth)."""
    init = _Init(generator, dtype)
    d, m, te, hd = cfg.hidden_size, cfg.mlp_hidden_dim, cfg.time_embed_dim, cfg.attention_head_dim

    def ln(width):
        return {"w": init.const((width,), 1.0), "b": init.const((width,), 0.0)}

    def block():
        return {
            "norm1": {"ln": ln(d), "lin": init.linear(te, 6 * d)},
            "norm2": {"ln": ln(d), "lin": init.linear(te, 6 * d)},
            "qkv": init.linear(d, 3 * d),
            "qnorm": ln(hd),
            "knorm": ln(hd),
            "proj": init.linear(d, d),
            "ff_in": init.linear(d, m),
            "ff_out": init.linear(m, d),
        }

    p = cfg.patch_size
    return {
        "patch_proj": init.linear(cfg.in_channels * p * p, d),
        "text_proj": init.linear(cfg.text_embed_dim, d),
        "time_lin1": init.linear(d, te),
        "time_lin2": init.linear(te, te),
        "blocks": init.stacked(block, cfg.num_layers),
        "norm_final": ln(d),
        "norm_out_ln": ln(d),
        "norm_out_lin": init.linear(te, 2 * d),
        "proj_out": init.linear(d, cfg.out_channels * p * p),
    }
