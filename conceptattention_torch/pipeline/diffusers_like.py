"""Diffusers-style pipeline with `concept_attention_kwargs` and true CFG.

Counterpart of the JAX package's `pipeline/diffusers_like.py`: the
HF-ecosystem-shaped entry point `__call__(prompt, ..., guidance_scale,
true_cfg, negative_prompt, concept_attention_kwargs={"concepts",
"timesteps", "layers"})` over a `ConceptAttentionFluxPipeline`'s weights.
The concept maps are kept for the selected timesteps and layers, and with
`true_cfg > 1` every step runs a second forward on the negative prompt.
Maps are normalized with a softmax over the patch axis (the diffusers
variant's convention), not over the concepts as the core pipeline does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from conceptattention_torch.ops.packing import make_img_ids, pack_latents
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.pipeline.concept_pipeline import _full_f32
from conceptattention_torch.pipeline.heatmaps import apply_attention_norm, heatmaps_to_pil
from conceptattention_torch.sampling.rectified_flow import denoise, get_noise


@dataclasses.dataclass
class FluxConceptAttentionOutput:
    images: List[Any]
    concept_attention_maps: List[Any]


def _denoise_cfg(params, cfg, img, img_ids, txt, txt_ids, vec, neg_txt, neg_vec,
                 concepts, concept_ids, concept_vec, timesteps, guidance,
                 guidance_scale, spec, true_cfg):
    """The Euler loop of `sampling/rectified_flow.denoise`, whose true-CFG
    branch both pipelines share."""
    return denoise(
        params, cfg, img, img_ids, txt, txt_ids, vec, timesteps, guidance,
        concepts=concepts, concept_ids=concept_ids, concept_vec=concept_vec, spec=spec,
        neg_txt=neg_txt, neg_vec=neg_vec, guidance_scale=guidance_scale, true_cfg=true_cfg,
    )


class FluxWithConceptAttentionPipeline:
    """HF-shaped wrapper over a `ConceptAttentionFluxPipeline`'s forward
    path; it shares the base pipeline's weights, device and attention
    backend."""

    def __init__(self, base_pipeline):
        self.base = base_pipeline

    @torch.inference_mode()
    @_full_f32()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 4,
        guidance_scale: float = 0.0,
        true_cfg: float = 1.0,
        seed: int = 0,
        concept_attention_kwargs: Optional[Dict[str, Any]] = None,
        output_type: str = "pil",
        cmap: str = "plasma",
    ) -> FluxConceptAttentionOutput:
        """One image and one map per concept, the mean over the selected
        timesteps (all by default) and layers (the last four double blocks
        by default) of the output-space maps. `guidance_scale` is the
        embedded guidance of guidance-distilled models, `true_cfg` the scale
        of the negative-prompt guidance (off at 1 or below); `output_type`
        "pil" gives PIL images, anything else arrays."""
        base = self.base
        kwargs = concept_attention_kwargs or {}
        concepts: List[str] = kwargs.get("concepts", [])
        if not concepts:
            raise ValueError("concept_attention_kwargs['concepts'] is required")
        map_timesteps: Optional[Sequence[int]] = kwargs.get("timesteps")
        layers: Optional[Sequence[int]] = kwargs.get("layers")
        if layers is None:
            layers = list(range(max(0, base.cfg.depth - 4), base.cfg.depth))

        noise = get_noise(
            torch.Generator(base.device).manual_seed(seed), 1, height, width, base.dtype,
            channels=base.spec.ae_params.z_channels, vae_factor=base.vae_factor,
        )
        b, _, lh, lw = noise.shape
        schedule = get_schedule(num_inference_steps, (lh // 2) * (lw // 2),
                                shift=not base.is_schnell)
        txt, txt_ids, vec = base._prepare_text(prompt, b)
        neg_txt, _, neg_vec = base._prepare_text(negative_prompt, b)
        c_emb, c_ids, c_vec = base._prepare_concepts(concepts, b)
        spec = dataclasses.replace(base.attention_spec, taps=("output",))
        latents, saliency = _denoise_cfg(
            base.params, base.cfg, pack_latents(noise),
            make_img_ids(lh // 2, lw // 2, b, device=base.device),
            txt, txt_ids, vec, neg_txt, neg_vec, c_emb, c_ids, c_vec, schedule,
            guidance_scale, true_cfg, spec, true_cfg > 1.0,
        )

        maps = saliency["output"].float()  # [S, L, B, C, P]
        if map_timesteps is not None:
            bad = [t for t in map_timesteps if not 0 <= int(t) < maps.shape[0]]
            if bad:
                raise ValueError(f"concept_attention_kwargs timesteps {bad} out of range "
                                 f"for {maps.shape[0]} inference steps")
            maps = maps[torch.as_tensor([int(t) for t in map_timesteps], device=maps.device)]
        bad = [l for l in layers if not 0 <= int(l) < maps.shape[1]]
        if bad:
            raise ValueError(f"concept_attention_kwargs layers {bad} out of range for "
                             f"{maps.shape[1]} double-stream layers")
        maps = maps[:, torch.as_tensor([int(l) for l in layers], device=maps.device)]
        maps = apply_attention_norm(maps, "softmax", dim=-1)  # over the patches
        maps = maps.mean(dim=(0, 1))[0].reshape(len(concepts), lh // 2, lw // 2)

        image = base._decode_image(latents, (lh // 2, lw // 2), watermark=False,
                                   return_image_array=output_type != "pil")
        map_arr = maps.cpu().numpy().astype(np.float32)
        map_out = heatmaps_to_pil(map_arr, cmap) if output_type == "pil" else list(map_arr)
        return FluxConceptAttentionOutput(images=[image], concept_attention_maps=map_out)
