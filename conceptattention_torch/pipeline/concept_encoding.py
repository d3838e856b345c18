"""Concept basis of a real image.

Counterpart of the JAX package's `pipeline/concept_encoding.py`: run the DiT
once on a noised real image, stopping after the double blocks, in the raw-
vector mode of `ConceptAttentionSpec`, and return the concept and image
vectors of one representation space ("output": the merged-head attention
outputs; "cross_attention": the pre-RoPE queries, heads merged), optionally
layer-selected, linearly normalized over concepts, and flattened into a
basis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.pipeline.concept_pipeline import _full_f32, batched_noise_saliency
from conceptattention_torch.pipeline.heatmaps import normalize_concepts_linear

_TAP_KEYS = {
    "output": ("output_space_image_vectors", "output_space_concept_vectors"),
    "cross_attention": ("cross_attention_image_vectors", "cross_attention_concept_vectors"),
}


def _merged(v: torch.Tensor) -> torch.Tensor:
    """[L, N, H, R, D] head form -> [L, N, R, H*D]; merged vectors pass."""
    if v.dim() == 5:
        l, n, h, r, d = v.shape
        return v.transpose(2, 3).reshape(l, n, r, h * d)
    return v


@torch.inference_mode()
@_full_f32()
def generate_concept_basis_and_image_representation(
    pipeline,
    image,
    caption: str,
    concepts: List[str],
    noise_timestep: int = 2,
    layers: Optional[Sequence[int]] = None,
    normalize_concepts: bool = True,
    num_steps: int = 4,
    seed: int = 63,
    target_space: str = "output",
    height: int = 1024,
    width: int = 1024,
    num_samples: int = 1,
    reduce_dims: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (image_vectors, concept_vectors) as f32 arrays.

    One batched forward over the `num_samples` noise samples (sample i
    draws from a generator seeded seed + i); the streams are modulated with
    the caption's pooled vector. Without `reduce_dims` the layout is
    ([L, N, P, D], [L, N, C, D]); with it ([P, L*N*D], [C, L*N*D]).
    """
    if target_space not in _TAP_KEYS:
        raise ValueError(f"target_space must be one of {sorted(_TAP_KEYS)}, got {target_space!r}")
    z = pipeline._encode_pixels(image, height, width, seed)
    _, _, lh, lw = z.shape
    schedule = get_schedule(num_steps, (lh // 2) * (lw // 2), shift=not pipeline.is_schnell)
    txt, txt_ids, vec = pipeline._prepare_text(caption, 1)
    c_emb, c_ids, c_vec = pipeline._prepare_concepts(concepts, 1)
    spec = ConceptAttentionSpec(
        return_raw_vectors=True, backend=pipeline.attention_spec.backend,
        mesh=pipeline.attention_spec.mesh,
    )
    raw = batched_noise_saliency(
        pipeline, z, schedule[noise_timestep], num_samples, height, width, seed,
        txt, txt_ids, vec, c_emb, c_ids, c_vec, spec,
    )
    img_key, con_key = _TAP_KEYS[target_space]
    # [N, L, 1, ...] samples leading -> [L, N, ...]
    iv, cv = (_merged(raw[k][:, :, 0].transpose(0, 1)) for k in (img_key, con_key))
    if layers is not None:
        n_layers = iv.shape[0]
        bad = [int(i) for i in layers if not 0 <= int(i) < n_layers]
        if bad:
            raise ValueError(f"layers {bad} out of range for {n_layers} layers")
        idx = torch.as_tensor([int(i) for i in layers], device=iv.device)
        iv, cv = iv[idx], cv[idx]
    image_vectors, concept_vectors = iv.float(), cv.float()
    if normalize_concepts:
        concept_vectors = normalize_concepts_linear(concept_vectors, dim=-2)
    if reduce_dims:
        l, s, p, d = image_vectors.shape
        image_vectors = image_vectors.permute(2, 0, 1, 3).reshape(p, l * s * d)
        concept_vectors = concept_vectors.permute(2, 0, 1, 3).reshape(-1, l * s * d)
    return image_vectors.cpu().numpy(), concept_vectors.cpu().numpy()
