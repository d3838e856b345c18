"""Flux DiT forward pass with the optional concept stream.

Counterpart of the JAX package's `models/flux/dit.py`: Python loops over
the 19 double and 38 single blocks of the stacked parameters. With
`concepts=None` this is the vanilla Flux forward; with concepts it adds the
third token stream and emits per-layer saliency maps.
`stop_after_multimodal_attentions` returns after the double blocks.
ControlNet residuals are added to the image stream after each block. With
`remat`, each block (its residual included) runs under
`torch.utils.checkpoint`: its backward recomputes the block from its inputs
instead of keeping every activation of every layer (the JAX package's
`jax.checkpoint` over the scan body; the training path sets it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.blocks import double_block, last_layer, single_block
from conceptattention_torch.models.flux.params import layer
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.embeddings import mlp_embedder, timestep_embedding
from conceptattention_torch.ops.rope import embed_nd


def _conditioning_vector(params, cfg: FluxConfig, timesteps, guidance, y):
    vec = mlp_embedder(timestep_embedding(timesteps, 256), params["time_in"])
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance_embed model requires a guidance strength")
        vec = vec + mlp_embedder(timestep_embedding(guidance, 256), params["guidance_in"])
    return vec + mlp_embedder(y, params["vector_in"])


def _controlnet_per_layer(samples: Optional[torch.Tensor], depth: int, repeat: bool):
    """[n, B, P, D] ControlNet residuals -> one [B, P, D] residual per layer
    (views): sample i % n when `repeat` (the XLabs layout), else
    i // ceil(depth / n) (diffusers' interval layout). None gives None."""
    if samples is None:
        return None
    n = samples.shape[0]
    if repeat:
        return [samples[i % n] for i in range(depth)]
    interval = -(-depth // n)  # ceil
    return [samples[min(i // interval, n - 1)] for i in range(depth)]


def _step(fn, remat: bool, *args):
    """fn(*args), under a non-reentrant checkpoint with `remat`. The layer's
    parameters are taken inside `fn`, so a derived view of them (a LoRA
    merge) is recomputed with the block rather than kept."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def flux_forward(
    params: Dict[str, Any],
    cfg: FluxConfig,
    img: torch.Tensor,
    img_ids: torch.Tensor,
    txt: torch.Tensor,
    txt_ids: torch.Tensor,
    timesteps: torch.Tensor,
    y: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    concepts: Optional[torch.Tensor] = None,
    concept_ids: Optional[torch.Tensor] = None,
    concept_vec: Optional[torch.Tensor] = None,
    stop_after_multimodal_attentions: bool = False,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
    controlnet_block_samples: Optional[torch.Tensor] = None,
    controlnet_single_block_samples: Optional[torch.Tensor] = None,
    controlnet_blocks_repeat: bool = False,
    remat: bool = False,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """Run the DiT.

    Args:
      img: [B, P, in_channels] packed latents; txt: [B, T, context_in_dim].
      img_ids / txt_ids / concept_ids: [B, L, 3] position ids.
      timesteps: [B] flow time in [0, 1]; y: [B, vec_in_dim] pooled vector.
      concepts: [B, C, context_in_dim] concept embeddings, or None.
      concept_vec: [B, vec_in_dim] concept pooled vector (zeros).
      controlnet_block_samples: [n, B, P, hidden] residuals added to the img
        stream after each double block, laid out per
        `controlnet_blocks_repeat` (`_controlnet_per_layer`).
      controlnet_single_block_samples: [m, B, P, hidden] residuals added to
        the image slice after each single block (interval layout).
      remat: rematerialize each block in the backward
        (`torch.utils.checkpoint`, non-reentrant).

    Returns (pred, saliency): pred [B, P, in_channels] (None when stopping
    after the double blocks), saliency {tap: [depth, B, C, P] f32} (empty
    without concepts; with `spec.return_raw_vectors`, the blocks' vector
    sets stacked over depth).
    """
    if img.dim() != 3 or txt.dim() != 3:
        raise ValueError("img and txt must be [B, L, D]")
    img = img @ params["img_in"]["w"] + params["img_in"]["b"]
    txt = txt @ params["txt_in"]["w"] + params["txt_in"]["b"]
    vec = _conditioning_vector(params, cfg, timesteps, guidance, y).to(img.dtype)
    pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)

    concept_pe = cvec = None
    if concepts is not None:
        cvec = _conditioning_vector(params, cfg, timesteps, guidance, concept_vec).to(img.dtype)
        concepts = concepts @ params["txt_in"]["w"] + params["txt_in"]["b"]
        concept_pe = embed_nd(
            torch.cat([concept_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta
        )

    cn_double = _controlnet_per_layer(controlnet_block_samples, cfg.depth,
                                      controlnet_blocks_repeat)

    def double_step(i, img, txt, concepts):
        img, txt, concepts, saliency = double_block(
            layer(params["double"], i), img, txt, vec, pe, cfg.num_heads,
            concepts=concepts, concept_vec=cvec, concept_pe=concept_pe, spec=spec,
        )
        if cn_double is not None:
            img = img + cn_double[i].to(img.dtype)
        return img, txt, concepts, saliency

    per_layer = []
    for i in range(cfg.depth):
        img, txt, concepts, saliency = _step(double_step, remat, i, img, txt, concepts)
        per_layer.append(saliency)
    saliency = {k: torch.stack([s[k] for s in per_layer]) for k in per_layer[0]}

    if stop_after_multimodal_attentions:
        return None, saliency

    t_len = txt.shape[1]
    x = torch.cat([txt, img], dim=1)
    cn_single = _controlnet_per_layer(controlnet_single_block_samples,
                                      cfg.depth_single_blocks, False)

    def single_step(i, x):
        x = single_block(
            layer(params["single"], i), x, vec, pe, cfg.num_heads, cfg.mlp_hidden_dim,
            backend=spec.backend, int8_qk=spec.int8_qk,
        )
        if cn_single is not None:  # the residual lands on the image slice only
            x = torch.cat([x[:, :t_len], x[:, t_len:] + cn_single[i].to(x.dtype)], dim=1)
        return x

    for i in range(cfg.depth_single_blocks):
        x = _step(single_step, remat, i, x)
    pred = last_layer(params["final"], x[:, t_len:], vec)
    return pred, saliency
