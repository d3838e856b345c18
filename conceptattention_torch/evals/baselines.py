"""The ViT-explainability baselines of the segmentation evaluation.

Counterpart of the JAX package's `evals/baselines.py`: DINO's last-layer
CLS attention (concept-agnostic), attention rollout, GradCAM on the
last-layer attention, and the Chefer relevance methods of `evals/lrp.py`
(transformer attribution, last-layer LRP, full LRP to the pixels). The
attention maps come from `vit_forward(..., return_attn=True)`; the gradients
from autograd through `attn_deltas`. The saliency runs in the parameters'
dtype (f32) with TF32 off, as the JAX package's f32 einsums.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch
import torch.nn.functional as F

from conceptattention_torch.evals.lrp import _attn_gradients, vit_relprop
from conceptattention_torch.evals.segmentation import SegmentationModel
from conceptattention_torch.models.vit import ViTConfig, vit_forward
from conceptattention_torch.pipeline.concept_pipeline import _full_f32
from conceptattention_torch.utils.images import as_float01_chw

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
METHODS = ("dino_attention", "rollout", "gradcam", "transformer_attribution",
           "last_layer_lrp", "lrp", "full_lrp")


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, size, size], bilinear, antialiased when it
    downsamples (as `jax.image.resize(..., "bilinear")`)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", antialias=True,
                         align_corners=False)


def _preprocess(image, size: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """PIL / array -> [1, 3, size, size] f32 on `device`: scaled to [0, 1]
    by dtype, normalised with the ImageNet mean and std, then resized."""
    arr = as_float01_chw(image)
    mean = np.array(IMAGENET_MEAN, np.float32)[:, None, None]
    std = np.array(IMAGENET_STD, np.float32)[:, None, None]
    x = torch.from_numpy((arr - mean) / std)[None].to(device)
    return resize_bilinear(x, size)


def attention_rollout(attns: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
    """Abnar & Zuidema rollout: the product of the row-normalised (head-mean
    attention + I). attns [depth, B, H, N, N] -> [B, N, N]."""
    a = attns.mean(dim=2)
    a = a + torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)[None]
    a = a / a.sum(dim=-1, keepdim=True)
    rolled = a[start_layer]
    for i in range(start_layer + 1, a.shape[0]):
        rolled = a[i] @ rolled
    return rolled


class ViTAttentionSegmentationModel(SegmentationModel):
    """Concept-agnostic ViT saliency baselines.

    method: "dino_attention" (last-layer CLS attention, head mean),
            "rollout" (row-normalised attention rollout),
            "gradcam" (the last layer's attention weighted per head by its
            gradient averaged over the CLS row's patch entries),
            "transformer_attribution" (gradient-weighted relevance rollout),
            "last_layer_lrp" (relevance of the last attention),
            "lrp" / "full_lrp" (relevance to the pixels with the zB rule,
            pooled to patches).
    The parameters' device is the model's."""

    def __init__(self, params, cfg: ViTConfig, method: str = "dino_attention"):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        self.params = params
        self.cfg = cfg
        self.method = method
        self.device = params["cls_token"].device

    @_full_f32()
    def saliency(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed images [B, 3, S, S] -> patch saliency [B, grid, grid]."""
        cfg, b = self.cfg, x.shape[0]
        if self.method in ("lrp", "full_lrp"):
            rel = vit_relprop(self.params, cfg, x, method="full")  # [B, H, W]
            ps, g = cfg.patch_size, cfg.grid
            sal = rel.reshape(b, g, ps, g, ps).sum(dim=(2, 4)).reshape(b, -1).relu()
        elif self.method in ("transformer_attribution", "last_layer_lrp"):
            sal = vit_relprop(self.params, cfg, x, method=(
                "transformer_attribution" if self.method == "transformer_attribution"
                else "last_layer"))
        else:
            logits, attns = vit_forward(self.params, cfg, x, return_attn=True)
            if self.method == "dino_attention":
                sal = attns[-1, :, :, 0, 1:].mean(dim=1)
            elif self.method == "rollout":
                sal = attention_rollout(attns)[:, 0, 1:]
            else:  # gradcam: per-head weights from the CLS row's patch gradients
                grads, attns = _attn_gradients(self.params, cfg, x, logits.argmax(dim=-1),
                                               return_attn=True)
                weights = grads[-1][:, :, 0, 1:].mean(dim=-1)[..., None, None]
                sal = (weights * attns[-1]).mean(dim=1).relu()[:, 0, 1:]
        return sal.reshape(b, cfg.grid, cfg.grid)

    def segment_individual_image(self, image, concepts: List[str], caption: str, **kw):
        x = _preprocess(image, self.cfg.image_size, self.device)
        sal = self.saliency(x)[0].detach().float().cpu().numpy()
        return np.stack([sal] * len(concepts)), None  # the same map for every concept
