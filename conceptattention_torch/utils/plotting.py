"""Heatmap helpers of the eval harnesses.

Counterpart of the JAX package's `utils/plotting.py`, of which only the
nearest-neighbour resize the harnesses use is ported; the overlays and plot
grids are not.
"""

from __future__ import annotations

import numpy as np


def upsample_nearest(heatmap: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of a [h, w] map to [height, width]: output
    row i reads row i * h // height (the harnesses' token grid -> label
    resolution)."""
    h, w = heatmap.shape
    rows = (np.arange(height) * h // height).clip(0, h - 1)
    cols = (np.arange(width) * w // width).clip(0, w - 1)
    return heatmap[rows][:, cols]
