"""The segmentation baselines by name: the harness's `--segmentation_model`.

Counterpart of the JAX package's `evals/model_zoo.py`:
  RawOutputSpace / RawCrossAttention / RawValueSpace (the flux taps), DAAMFlux,
  CheferLRP / CheferRollout / CheferLastLayerAttention /
  CheferAttentionGradCAM / CheferTransformerAttribution / CheferFullLRP /
  CheferLastLayerLRP, DINO, DAAMSD2 / DAAMSDXL, TextSpan.

Weights come from `.safetensors` checkpoints named by environment variables:
  CHEFER_VITB16   -- a ViT-B/16 ImageNet classifier (the Chefer methods);
  DINO_VITB16     -- DINO ViT-B/16;
  SD2_UNET        -- the stable-diffusion-2-base UNet (DAAMSD2);
  SDXL_UNET       -- the sd_xl_base UNet (DAAMSDXL);
  OPENCLIP_VITH14 -- open_clip ViT-H/14 (TextSpan).
`random_weights=True` draws seeded random parameters instead, for smoke
runs only: the metrics are then meaningless. Every baseline but the flux
taps runs in f32 on `device` ("cuda" unless asked otherwise).
"""

from __future__ import annotations

import os
from typing import Any, Union

import torch

MODEL_CHOICES = (
    "RawOutputSpace", "RawCrossAttention", "RawValueSpace", "DAAMFlux",
    "CheferLRP", "CheferRollout", "CheferLastLayerAttention",
    "CheferAttentionGradCAM", "CheferTransformerAttribution",
    "CheferFullLRP", "CheferLastLayerLRP",
    "DINO", "DAAMSD2", "DAAMSDXL", "TextSpan",
)
FLUX_MODELS = ("RawOutputSpace", "RawCrossAttention", "RawValueSpace", "DAAMFlux")

# Chefer harness name -> `evals/baselines.py` method. "CheferLRP" is the full
# propagation to the pixels.
_CHEFER_METHODS = {
    "CheferLRP": "lrp",
    "CheferRollout": "rollout",
    "CheferLastLayerAttention": "dino_attention",
    "CheferAttentionGradCAM": "gradcam",
    "CheferTransformerAttribution": "transformer_attribution",
    "CheferFullLRP": "full_lrp",
    "CheferLastLayerLRP": "last_layer_lrp",
}

DeviceLike = Union[str, torch.device]


def _load_or_init_vit(env_var: str, cfg, random_weights: bool, seed: int = 0,
                      device: DeviceLike = "cuda", dtype: torch.dtype = torch.float32):
    from conceptattention_torch.models.vit import init_vit_params

    path = os.environ.get(env_var, "")
    if path:
        from conceptattention_torch.weights.convert import (
            convert_vit_state_dict,
            load_safetensors,
        )

        return convert_vit_state_dict(load_safetensors(path), cfg, dtype, device)
    if not random_weights:
        raise FileNotFoundError(
            f"set ${env_var} to a ViT checkpoint (or pass random_weights=True "
            "for a smoke run with meaningless metrics)")
    return init_vit_params(torch.Generator(device).manual_seed(seed), cfg, dtype)


def tiny_configs(name: str) -> dict:
    """Seconds-scale CPU configs per baseline family, for smoke runs
    (`tiny=True`); the metrics are meaningless. The flux taps take their
    size from the pipeline's model name."""
    from conceptattention_torch.models.clip_vit import OpenCLIPTextConfig, OpenCLIPVisionConfig
    from conceptattention_torch.models.sd_unet import UNetConfig
    from conceptattention_torch.models.vit import ViTConfig

    if name in _CHEFER_METHODS or name == "DINO":
        return {"vit_cfg": ViTConfig(image_size=32, patch_size=8, hidden_size=32, depth=2,
                                     num_heads=2, num_classes=5)}
    if name == "DAAMSD2":
        return {"unet_cfg": UNetConfig(block_out_channels=(16, 32), layers_per_block=1,
                                       attention_heads=(2, 2), cross_attention_levels=(True, False),
                                       context_dim=8, num_groups=4)}
    if name == "DAAMSDXL":
        return {"unet_cfg": UNetConfig(block_out_channels=(16, 32), layers_per_block=1,
                                       attention_heads=(2, 2), cross_attention_levels=(False, True),
                                       context_dim=8, num_groups=4,
                                       transformer_layers_per_block=(1, 2),
                                       addition_embed_type="text_time", addition_time_embed_dim=4,
                                       projection_class_embeddings_input_dim=8 + 24)}
    if name == "TextSpan":
        return {"vit_cfg": OpenCLIPVisionConfig(image_size=28, patch_size=14, width=32, depth=2,
                                                num_heads=2, embed_dim=16),
                "clip_txt_cfg": OpenCLIPTextConfig(context_length=16, vocab_size=64, width=32,
                                                   depth=2, num_heads=2, embed_dim=16)}
    return {}


def build_segmentation_model(
    name: str,
    pipeline=None,
    random_weights: bool = False,
    tiny: bool = False,
    vit_cfg=None,
    unet_cfg=None,
    clip_txt_cfg=None,
    text_encoders=None,
    device: DeviceLike = "cuda",
    dtype: torch.dtype = torch.float32,
    **tap_kwargs: Any,
):
    """name -> a SegmentationModel. The flux models need `pipeline` (a
    `ConceptAttentionFluxPipeline`, whose device they use) and take
    `tap_kwargs` (num_steps, noise_timestep, layer_indices, width, ...);
    the DAAM-SD models take them too (latent_size, seed, ...), and
    `text_encoders` (a `StubTextEncoders` of the UNet's widths by default).
    `tiny=True` fills a config left as None from `tiny_configs`."""
    if name not in MODEL_CHOICES:
        raise ValueError(f"unknown model {name!r}; choose from {MODEL_CHOICES}")
    if tiny:
        tiny_cfgs = tiny_configs(name)
        vit_cfg = vit_cfg or tiny_cfgs.get("vit_cfg")
        unet_cfg = unet_cfg or tiny_cfgs.get("unet_cfg")
        clip_txt_cfg = clip_txt_cfg or tiny_cfgs.get("clip_txt_cfg")

    if name in FLUX_MODELS:
        from conceptattention_torch.evals.segmentation import (
            DAAMFluxSegmentationModel,
            FluxTapSegmentationModel,
        )

        if pipeline is None:
            raise ValueError(f"{name} needs the flux `pipeline`")
        if name == "DAAMFlux":
            return DAAMFluxSegmentationModel(pipeline, **tap_kwargs)
        tap = {"RawOutputSpace": "output", "RawCrossAttention": "cross_attention",
               "RawValueSpace": "value"}[name]
        return FluxTapSegmentationModel(pipeline, tap=tap, **tap_kwargs)

    if name in _CHEFER_METHODS or name == "DINO":
        from conceptattention_torch.evals.baselines import ViTAttentionSegmentationModel
        from conceptattention_torch.models.vit import ViTConfig

        cfg = vit_cfg or ViTConfig()
        env = "DINO_VITB16" if name == "DINO" else "CHEFER_VITB16"
        method = "dino_attention" if name == "DINO" else _CHEFER_METHODS[name]
        params = _load_or_init_vit(env, cfg, random_weights, device=device, dtype=dtype)
        return ViTAttentionSegmentationModel(params, cfg, method=method)

    if name in ("DAAMSD2", "DAAMSDXL"):
        from conceptattention_torch.evals.segmentation import (
            DAAMStableDiffusionSegmentationModel,
            DAAMStableDiffusionXLSegmentationModel,
        )
        from conceptattention_torch.models.sd_unet import (
            SDXL_BASE_CONFIG,
            UNetConfig,
            init_unet_params,
        )
        from conceptattention_torch.models.text.encoders import StubTextEncoders

        xl = name == "DAAMSDXL"
        cfg = unet_cfg or (SDXL_BASE_CONFIG if xl else UNetConfig())
        env = "SDXL_UNET" if xl else "SD2_UNET"
        path = os.environ.get(env, "")
        if path:
            from conceptattention_torch.weights.convert import (
                convert_sd_unet_state_dict,
                load_safetensors,
            )

            params = convert_sd_unet_state_dict(load_safetensors(path), cfg, dtype, device)
        elif random_weights:
            params = init_unet_params(torch.Generator(device).manual_seed(0), cfg, dtype)
        else:
            raise FileNotFoundError(f"set ${env} to a UNet checkpoint (or random_weights=True)")
        enc = text_encoders or StubTextEncoders(
            t5_dim=cfg.context_dim, clip_dim=cfg.pooled_text_dim if xl else 768)
        cls = DAAMStableDiffusionXLSegmentationModel if xl else DAAMStableDiffusionSegmentationModel
        return cls(params, cfg, enc, **tap_kwargs)

    # TextSpan
    from conceptattention_torch.evals.textspan import OpenCLIPTextSpanSegmentationModel
    from conceptattention_torch.models.clip_vit import (
        OpenCLIPTextConfig,
        OpenCLIPVisionConfig,
        convert_open_clip_text,
        convert_open_clip_visual,
        init_open_clip_params,
    )

    vis_cfg = vit_cfg if isinstance(vit_cfg, OpenCLIPVisionConfig) else OpenCLIPVisionConfig()
    txt_cfg = clip_txt_cfg or OpenCLIPTextConfig()
    path = os.environ.get("OPENCLIP_VITH14", "")
    if path:
        from conceptattention_torch.weights.convert import load_safetensors

        sd = load_safetensors(path)
        params = {"visual": convert_open_clip_visual(sd, vis_cfg, dtype, device),
                  "text": convert_open_clip_text(sd, txt_cfg, dtype, device)}
    elif random_weights:
        params = init_open_clip_params(torch.Generator(device).manual_seed(0), vis_cfg,
                                       txt_cfg, dtype)
    else:
        raise FileNotFoundError("set $OPENCLIP_VITH14 to an open_clip ViT-H/14 checkpoint "
                                "(or random_weights=True)")
    return OpenCLIPTextSpanSegmentationModel(params, vis_cfg, txt_cfg)
