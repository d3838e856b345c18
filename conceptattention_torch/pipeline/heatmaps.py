"""Concept heatmap post-processing.

Counterpart of the JAX package's `pipeline/heatmaps.py`: raw [T, L, B, C, P]
concept-by-patch similarity maps are normalized across concepts per patch
(softmax, entmax15 or sparsemax), then the selected timesteps and layers are
averaged and the patch axis reshaped to the 2D grid.
`compute_heatmaps_from_vectors` does the same from full vector sets (the
raw-vector mode of the double blocks).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from conceptattention_torch.ops.sparse import entmax15, sparsemax
from conceptattention_torch.utils.profiling import PIPELINE_REDUCE_MAPS, span


def normalize_concepts_linear(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift to non-negative, then L1-normalize along `dim` (a zero sum
    divides by one)."""
    shifted = x - x.amin(dim=dim, keepdim=True)
    total = shifted.sum(dim=dim, keepdim=True)
    return shifted / torch.where(total == 0, torch.ones_like(total), total)


def apply_attention_norm(maps: torch.Tensor, attention_norm: str, dim: int = -2) -> torch.Tensor:
    """Normalize similarity maps across the concept axis."""
    if attention_norm == "softmax":
        return torch.softmax(maps, dim=dim)
    if attention_norm == "entmax15":
        return entmax15(maps, dim=dim)
    if attention_norm == "sparsemax":
        return sparsemax(maps, dim=dim)
    if attention_norm == "none":
        return maps
    raise ValueError(f"Unknown attention_norm={attention_norm!r}")


def _checked_index(indices: Sequence[int], size: int, what: str, device) -> torch.Tensor:
    # Tensor indexing wraps negative indices; the JAX package rejects them,
    # so every index is range-checked here.
    bad = [int(i) for i in indices if not 0 <= int(i) < size]
    if bad:
        raise ValueError(f"{what} {bad} out of range for {size}")
    return torch.as_tensor([int(i) for i in indices], dtype=torch.long, device=device)


def reduce_maps(
    maps: torch.Tensor,
    layer_indices: Sequence[int],
    timesteps: Optional[Sequence[int]] = None,
    softmax: bool = True,
    attention_norm: str = "sparsemax",
    spatial_shape: Optional[tuple] = None,
) -> torch.Tensor:
    """[T, L, B, C, P] raw similarity maps -> [B, C, h, w] heatmaps: normalize
    over concepts, select timesteps and layers, then average.
    `softmax=True` overrides attention_norm."""
    with span(PIPELINE_REDUCE_MAPS):
        norm = "softmax" if (softmax or attention_norm == "softmax") else attention_norm
        maps = apply_attention_norm(maps.float(), norm, dim=-2)
        if timesteps is not None:
            maps = maps[_checked_index(timesteps, maps.shape[0], "timesteps", maps.device)]
        maps = maps[:, _checked_index(layer_indices, maps.shape[1], "layer_indices", maps.device)]
        maps = maps.mean(dim=(0, 1))
        b, c, p = maps.shape
        if spatial_shape is None:
            side = int(round(p**0.5))
            spatial_shape = (side, side)
        h, w = spatial_shape
        if h * w != p:
            raise ValueError(f"spatial_shape {spatial_shape} does not hold {p} patches")
        return maps.reshape(b, c, h, w)


def compute_heatmaps_from_vectors(
    image_vectors: torch.Tensor,
    concept_vectors: torch.Tensor,
    layer_indices: Sequence[int],
    timesteps: Optional[Sequence[int]] = None,
    softmax: bool = True,
    normalize_concepts: bool = False,
    attention_norm: str = "sparsemax",
    spatial_shape: Optional[tuple] = None,
) -> torch.Tensor:
    """Heatmaps from full vector sets: image_vectors [T, L, B, P, D] or, in
    head form, [T, L, B, H, P, D]; concept_vectors the same with C rows.
    The concept-by-patch products go through `reduce_maps`; returns
    [B, C, h, w]."""
    if image_vectors.dim() == 6:
        t, l, b, h, p, d = image_vectors.shape
        image_vectors = image_vectors.transpose(3, 4).reshape(t, l, b, p, h * d)
        c = concept_vectors.shape[4]
        concept_vectors = concept_vectors.transpose(3, 4).reshape(t, l, b, c, h * d)
    if normalize_concepts:
        concept_vectors = normalize_concepts_linear(concept_vectors, dim=-2)
    maps = torch.einsum("tlbpd,tlbcd->tlbcp", image_vectors.float(), concept_vectors.float())
    return reduce_maps(maps, layer_indices, timesteps, softmax, attention_norm, spatial_shape)


def _colormap(cmap: str):
    """A function from values in [0, 1] to RGB in [0, 1]: the copied tables
    of `utils/colormaps.py` for the names they hold (no matplotlib needed),
    else matplotlib's colormap of that name."""
    from conceptattention_torch.utils import colormaps

    if cmap in colormaps.NAMES:
        return lambda x: colormaps.apply(cmap, x)
    from matplotlib import pyplot as plt

    colormap = plt.get_cmap(cmap)
    return lambda x: colormap(x)[..., :3]


def cmap_available(cmap: str) -> bool:
    """Whether `heatmaps_to_pil` can colour with `cmap` here."""
    try:
        _colormap(cmap)
    except (ImportError, ValueError):
        return False
    return True


def heatmaps_to_pil(heatmaps, cmap: str = "plasma") -> List:
    """[C, h, w] float heatmaps -> PIL images through a matplotlib colormap
    (`_colormap`) with one global min/max normalization."""
    import numpy as np
    import PIL.Image

    arr = np.asarray(heatmaps, dtype=np.float32)
    lo, hi = arr.min(), arr.max()
    scale = (hi - lo) if hi > lo else 1.0
    colormap = _colormap(cmap)
    return [PIL.Image.fromarray((colormap((hm - lo) / scale) * 255).astype(np.uint8)) for hm in arr]
