"""HunyuanVideo (tencent/HunyuanVideo): the 13B MM-DiT video model on the
Flux blocks, with its token refiner.

HunyuanVideo's transformer is Flux's at another size: 20 dual-stream and 40
single-stream blocks of 24 heads of 128, the same modulated LayerNorms,
per-head RMS q/k norms, GELU-tanh MLPs, parallel single blocks and final
layer, embedded (distilled) guidance, and Flux's 3-axis interleaved RoPE
over (t, h, w) ids at theta 256 with text at id 0 (the identity rotation).
So the forward is `models/flux/dit.flux_forward` with `HunyuanVideoConfig`
and one hook: text enters through the token refiner (`token_refiner`,
HunyuanVideo's `SingleTokenRefiner`) in place of Flux's linear `txt_in`.

  refiner: c = t_embedder(t) + c_embedder(masked mean of the text states);
           x = input_embedder(text); 2 blocks of
           x += gate_msa * proj(self-attention(LN(x)))   (qkv with bias, no q/k norm)
           x += gate_mlp * mlp(LN(x))                    (Linear, SiLU, Linear; 4x)
           with (gate_msa, gate_mlp) = Linear(silu(c)) and affine LayerNorms (eps 1e-6).

Latents [B, F, 16, H, W] enter as per-frame 2x2 patches, channel-outer
(`ops/packing.pack_latents` on each frame: the Conv3d patch embedding with
kernel (1, 2, 2) is one linear of 64 -> 3072), frame-major tokens.

Padded text never acts as a key for valid tokens (the published model
splits each row by `cu_seqlens`). At B=1 the pipeline cuts the text to its
valid length, which is exact; the fused attention has no key mask, so the
forward takes text whose every row is valid.

The concept stream is this repository's extension, not the paper's (the
paper hooks Flux): the concepts go through the refiner as a sequence of
their own (c from their own mean, as Flux sends them through its own
`txt_in`), take ids 0, and are modulated by the conditioning vector of a
zero pooled input, as in Flux. The quantized, LoRA, ring and
tensor-parallel paths are not ported for this model and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.blocks import _linear
from conceptattention_torch.models.flux.dit import flux_forward
from conceptattention_torch.models.flux.params import Params, _Init, init_flux_params, layer
from conceptattention_torch.models.video.dit import make_video_ids
from conceptattention_torch.ops.attention import (
    RING_BACKENDS,
    ConceptAttentionSpec,
    merge_heads,
    sdpa,
)
from conceptattention_torch.ops.embeddings import mlp_embedder, timestep_embedding
from conceptattention_torch.ops.norms import layer_norm
from conceptattention_torch.ops.packing import pack_latents, unpack_latents
from conceptattention_torch.parallel.sharding import tree_mesh
from conceptattention_torch.utils.profiling import DIT_REFINER, span


@dataclasses.dataclass(frozen=True)
class HunyuanVideoConfig(FluxConfig):
    """HunyuanVideo's transformer as a Flux config plus the refiner, the
    text slots and the flow schedule's shift. `in_channels`, the packed
    1 x 2 x 2 patch, follows from `latent_channels`."""

    in_channels: int = dataclasses.field(init=False, default=64)
    depth: int = 20
    depth_single_blocks: int = 40
    theta: int = 256
    guidance_embed: bool = True
    latent_channels: int = 16
    num_refiner_layers: int = 2
    text_len: int = 256  # LLaVA-LLaMA-3-8B slots
    flow_shift: float = 7.0

    def __post_init__(self):
        object.__setattr__(self, "in_channels", 4 * self.latent_channels)
        super().__post_init__()

    @property
    def patch_size(self) -> int:
        """The spatial patch `patchify` packs, one frame a patch."""
        return 2


def hunyuanvideo_config(**overrides) -> HunyuanVideoConfig:
    """The published transformer (hunyuanvideo-community/HunyuanVideo,
    `transformer/config.json`): 20 + 40 blocks, 24 heads of 128, 2 refiner
    blocks, text 4096 wide in 256 slots, pooled CLIP 768, RoPE axes
    16/56/56 at theta 256, 16 latent channels; scheduler shift 7.0."""
    return HunyuanVideoConfig(**overrides)


def hunyuanvideo_tiny_config(**overrides) -> HunyuanVideoConfig:
    """A CPU-test size: hidden 128 (4 heads of 32), 2 + 2 blocks, 2 refiner
    blocks, RoPE axes 8/12/12, text 64 wide in 16 slots, pooled 32, 4 latent
    channels."""
    base = dict(hidden_size=128, num_heads=4, depth=2, depth_single_blocks=2,
                axes_dim=(8, 12, 12), context_in_dim=64, vec_in_dim=32, latent_channels=4,
                text_len=16)
    base.update(overrides)
    return HunyuanVideoConfig(**base)


def init_hunyuan_video_params(generator: torch.Generator, cfg: HunyuanVideoConfig,
                              dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random parameters on the generator's device in Flux's stacked layout
    (`init_flux_params`: `img_in`, `time_in`, `guidance_in`, `vector_in`,
    `final`, `double` [depth], `single` [depth_single]) with `refiner` in
    place of `txt_in`: `input_embedder`, `t_embedder` and `c_embedder` (MLP
    embedders), and `blocks` stacked by refiner depth (affine norms `norm1`,
    `norm2`; `qkv` [D, 3, H, head_dim]; `proj`; `mlp_in`, `mlp_out`;
    `adaln` [D, 2D]). Linear weights N(0, 1/in_features), zero biases, unit
    norm scales."""
    params = init_flux_params(generator, cfg, dtype)
    del params["txt_in"]  # the refiner embeds the text
    init = _Init(generator, dtype)
    d, m = cfg.hidden_size, cfg.mlp_hidden_dim

    def block():
        return {"norm1": {"w": init.const((d,), 1.0), "b": init.const((d,), 0.0)},
                "qkv": init.qkv(cfg, bias=True), "proj": init.linear(d, d),
                "norm2": {"w": init.const((d,), 1.0), "b": init.const((d,), 0.0)},
                "mlp_in": init.linear(d, m), "mlp_out": init.linear(m, d),
                "adaln": init.linear(d, 2 * d)}

    params["refiner"] = {
        "input_embedder": init.linear(cfg.context_in_dim, d),
        "t_embedder": init.mlp_embedder(256, d),
        "c_embedder": init.mlp_embedder(cfg.context_in_dim, d),
        "blocks": init.stacked(block, cfg.num_refiner_layers),
    }
    return params


def token_refiner(params: Params, cfg: HunyuanVideoConfig, text: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
    """HunyuanVideo's `SingleTokenRefiner` on [B, T, context_in_dim] text
    states, every slot valid, at flow times `timesteps` [B] in [0, 1]:
    -> [B, T, hidden] in the parameters' dtype. The published model masks
    its padded slots out of the pooled mean and out of every valid row's
    keys; the pipeline cuts them away instead, which is the same at B=1."""
    p = params["refiner"]
    with span(DIT_REFINER):
        dt = p["input_embedder"]["w"].dtype
        c = (mlp_embedder(timestep_embedding(timesteps, 256), p["t_embedder"])
             + mlp_embedder(text.float().mean(dim=1), p["c_embedder"])).to(dt)
        x = _linear(text.to(dt), p["input_embedder"])
        b, n, d = x.shape
        for i in range(cfg.num_refiner_layers):
            lp = layer(p["blocks"], i)
            gate_msa, gate_mlp = _linear(F.silu(c), lp["adaln"])[:, None].chunk(2, dim=-1)
            h = layer_norm(x) * lp["norm1"]["w"] + lp["norm1"]["b"]
            qkv = _linear(h, {"w": lp["qkv"]["w"].reshape(d, -1), "b": lp["qkv"]["b"].reshape(-1)})
            q, k, v = qkv.reshape(b, n, 3, cfg.num_heads, -1).permute(2, 0, 3, 1, 4)
            x = x + gate_msa * _linear(merge_heads(sdpa(q, k, v)), lp["proj"])
            h = layer_norm(x) * lp["norm2"]["w"] + lp["norm2"]["b"]
            x = x + gate_mlp * _linear(F.silu(_linear(h, lp["mlp_in"])), lp["mlp_out"])
        return x


def _refined(cfg: HunyuanVideoConfig):
    """The text-embedder hook of `flux_forward`: the refiner over every row."""
    return lambda params, x, timesteps: token_refiner(params, cfg, x, timesteps)


def patchify(video: torch.Tensor) -> torch.Tensor:
    """[B, F, C, H, W] latents -> [B, F*(H/2)*(W/2), C*4] tokens, frame-major,
    each frame packed 2x2 channel-outer."""
    b, f, c, h, w = video.shape
    return pack_latents(video.reshape(b * f, c, h, w)).reshape(b, f * (h // 2) * (w // 2), c * 4)


def unpatchify(tokens: torch.Tensor, frames: int, height: int, width: int) -> torch.Tensor:
    """The inverse of `patchify`: -> [B, F, C, H, W]."""
    b, _, cd = tokens.shape
    per_frame = tokens.reshape(b * frames, (height // 2) * (width // 2), cd)
    return unpack_latents(per_frame, height // 2, width // 2).reshape(
        b, frames, cd // 4, height, width)


def hunyuan_video_forward(
    params: Params,
    cfg: HunyuanVideoConfig,
    video: torch.Tensor,
    txt: torch.Tensor,
    timesteps: torch.Tensor,
    y: torch.Tensor,
    guidance: torch.Tensor,
    concepts: Optional[torch.Tensor] = None,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The transformer on latents `video` [B, F, C, H, W], valid text `txt`
    [B, T, context_in_dim], flow times [B] in [0, 1], pooled CLIP `y`
    [B, vec_in_dim] and embedded guidance [B] (6.0 for the published
    model), with optional `concepts` [B, C, context_in_dim].

    Returns (velocity [B, F, C, H, W], saliency {tap: [depth, B, C, F*P]})
    from `flux_forward`, whose `ca.dit.forward` span holds the refiner's."""
    if spec.backend in RING_BACKENDS or tree_mesh(params) is not None:
        raise NotImplementedError("HunyuanVideo runs on one device: the ring and "
                                  "tensor-parallel paths are not ported for it")
    b, f, _, h, w = video.shape
    dev = video.device
    img_ids = make_video_ids(f, h // 2, w // 2, batch_size=b, device=dev)
    con_kw: Dict[str, Any] = {}
    if concepts is not None:
        con_kw = dict(concepts=concepts,
                      concept_ids=torch.zeros((b, concepts.shape[1], 3), device=dev),
                      concept_vec=torch.zeros((b, cfg.vec_in_dim), device=dev, dtype=y.dtype))
    pred, saliency = flux_forward(
        params, cfg, img=patchify(video), img_ids=img_ids, txt=txt,
        txt_ids=torch.zeros((b, txt.shape[1], 3), device=dev), timesteps=timesteps, y=y,
        guidance=guidance, spec=spec, text_embedder=_refined(cfg), **con_kw)
    return unpatchify(pred, f, h, w), saliency
