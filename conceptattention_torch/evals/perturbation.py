"""The positive and negative perturbation test of ViT explanations.

Counterpart of the JAX package's `evals/perturbation.py`: given per-pixel
relevance, mask the top fraction of pixels (the most relevant first for the
positive test, the least relevant first for the negative one) at steps 0.1
to 0.9, classify again, and record the accuracy and the drop of the target's
probability per step. A faithful explanation loses accuracy fast in the
positive test and slowly in the negative one; the area under the accuracy
curve sums it up.

The whole sweep is one [steps x B] classification batch on the card. The
pixels are ranked once per sweep, with the JAX package's tie order: a
stable ascending sort reversed, so among equal relevances the later pixel
ranks first. Upsampled token relevance is all ties (256 equal pixels a
ViT-B/16 token), and a cut through a tied block masks the same pixels as
JAX only in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from conceptattention_torch.pipeline.concept_pipeline import _full_f32

PERTURBATION_STEPS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


@dataclasses.dataclass
class PerturbationResult:
    steps: Sequence[float]
    accuracy: np.ndarray  # [num_steps] mean top-1 accuracy after masking
    target_prob_drop: np.ndarray  # [num_steps] mean drop of P(target) from the unmasked image
    auc: float  # trapezoidal area under accuracy(step)
    logit_diff: Optional[np.ndarray] = None  # mean(max logit - unmasked max logit)
    dissimilarity: Optional[np.ndarray] = None  # mean log(P(target) / P(second best))

    def as_dict(self) -> Dict[str, object]:
        out = {"steps": list(self.steps), "accuracy": self.accuracy.tolist(),
               "target_prob_drop": self.target_prob_drop.tolist(), "auc": float(self.auc)}
        if self.logit_diff is not None:
            out["logit_diff"] = self.logit_diff.tolist()
        if self.dissimilarity is not None:
            out["dissimilarity"] = self.dissimilarity.tolist()
        return out


def _pixel_ranks(relevance: torch.Tensor) -> torch.Tensor:
    """[B, N] descending relevance ranks (0 = most relevant), ties in the
    JAX package's order (the later pixel first). The ranking does not
    depend on the fraction, so it is computed once per sweep."""
    order = torch.argsort(relevance, dim=-1, stable=True).flip(-1)
    return torch.argsort(order, dim=-1)


def _mask_top_pixels(images: torch.Tensor, ranks: torch.Tensor, k: int, fill=None):
    """Replace the k most relevant pixels of each image [B, C, H, W] by
    `fill` (per channel [C]; zero by default). The reference zeroes the
    pixels before normalising: on normalised inputs that is the fill
    -mean/std, not zero."""
    b, c, h, w = images.shape
    keep = (ranks >= k).reshape(b, 1, h, w)
    if fill is None:
        return images * keep
    fill = torch.as_tensor(fill, dtype=images.dtype, device=images.device).reshape(1, c, 1, 1)
    return torch.where(keep, images, fill)


@torch.no_grad()
def run_perturbation_eval(
    classify: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    labels: torch.Tensor,
    relevance: torch.Tensor,
    negative: bool = False,
    steps: Sequence[float] = PERTURBATION_STEPS,
    fill=None,
) -> PerturbationResult:
    """The perturbation sweep.

    classify: [B, C, H, W] -> logits [B, num_classes]; images [B, C, H, W]
    preprocessed; labels [B]; relevance [B, H, W] or [B, H*W] per pixel
    (`upsample_token_relevance` for token maps); `negative` masks the least
    relevant pixels first; `fill` is the per-channel value of a masked
    pixel (-mean/std reproduces the reference on normalised inputs)."""
    b, _, h, w = images.shape
    rel = relevance.reshape(b, h * w).float()
    if negative:
        rel = -rel
    base_logits = classify(images)
    base_p_target = torch.softmax(base_logits, dim=-1).gather(1, labels[:, None])[:, 0]

    n = h * w
    ranks = _pixel_ranks(rel)
    s = len(steps)
    masked = torch.cat([_mask_top_pixels(images, ranks, int(n * f), fill) for f in steps])
    logits = classify(masked).reshape(s, b, -1)
    probs = torch.softmax(logits, dim=-1)
    p_target = probs.gather(2, labels[None, :, None].expand(s, b, 1))[..., 0]
    accs = (logits.argmax(dim=-1) == labels[None, :]).float().mean(dim=1)
    drops = (base_p_target[None, :] - p_target).mean(dim=1)
    logit_diff = (logits.max(dim=-1).values - base_logits.max(dim=-1).values[None, :]).mean(dim=1)
    second = torch.topk(probs, 2, dim=-1).values[..., 1]
    dissim = torch.log((p_target + 1e-12) / (second + 1e-12)).mean(dim=1)

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    accuracy = host(accs)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
    auc = float(trapezoid(accuracy, np.asarray(steps)))
    return PerturbationResult(steps, accuracy, host(drops), auc, logit_diff=host(logit_diff),
                              dissimilarity=host(dissim))


def upsample_token_relevance(token_rel: torch.Tensor, image_size: int) -> torch.Tensor:
    """[B, g, g] token relevance -> [B, H, W] pixel relevance, nearest
    neighbour sampled at pixel centres (as `jax.image.resize(..., "nearest")`)."""
    return F.interpolate(token_rel.float()[:, None], size=(image_size, image_size),
                         mode="nearest-exact")[:, 0]


CHEFER_METHODS = (
    "rollout",
    "last_layer_attn",
    "gradcam",
    "transformer_attribution",
    "last_layer_lrp",
    "lrp",
    "full_lrp",
)


@_full_f32()
def compute_vit_relevance(params, cfg, x: torch.Tensor, method: str,
                          index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relevance of one of the 7 Chefer explanation methods for the class
    `index` ([B] labels; the predicted class when None), in the
    parameters' dtype: [B, grid, grid] for the token methods, [B, H, W]
    for the pixel LRP ("lrp", "full_lrp")."""
    from conceptattention_torch.evals.baselines import attention_rollout
    from conceptattention_torch.evals.lrp import _attn_gradients, vit_relprop
    from conceptattention_torch.models.vit import vit_forward

    if method in ("rollout", "last_layer_attn"):
        with torch.no_grad():
            _, attns = vit_forward(params, cfg, x, return_attn=True)
        sal = (attention_rollout(attns)[:, 0, 1:] if method == "rollout"
               else attns[-1, :, :, 0, 1:].mean(dim=1))
    elif method == "gradcam":
        if index is None:
            with torch.no_grad():
                index = vit_forward(params, cfg, x)[0].argmax(dim=-1)
        grads, attns = _attn_gradients(params, cfg, x, index, return_attn=True)
        weights = grads[-1][:, :, 0, 1:].mean(dim=-1)[..., None, None]
        sal = (weights * attns[-1]).mean(dim=1).relu()[:, 0, 1:]
    elif method in ("transformer_attribution", "last_layer_lrp", "lrp", "full_lrp"):
        m = {"transformer_attribution": "transformer_attribution",
             "last_layer_lrp": "last_layer", "lrp": "full", "full_lrp": "full"}[method]
        with torch.no_grad():
            rel = vit_relprop(params, cfg, x, index=index, method=m)
        if m == "full":
            return rel.relu()
        sal = rel
    else:
        raise ValueError(f"unknown method {method!r}; one of {CHEFER_METHODS}")
    return sal.reshape(-1, cfg.grid, cfg.grid).detach()
