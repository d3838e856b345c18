"""Heatmap figures and the harnesses' map resize.

Counterpart of the JAX package's `utils/plotting.py`: the nearest-neighbour
resize, heatmap-on-image overlays, a row of per-concept (or per-method)
heatmap panels and a single coefficient map with its colour bar. The
figures are drawn with PIL (imported when one is drawn) and colour maps
through `utils/colormaps`, matplotlib's own tables, so they need no
matplotlib: the card's machine may lack it. A figure is returned as a PIL
image, or saved to `save_path`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from conceptattention_torch.utils import colormaps

PANEL = 256  # pixels a side of one figure panel
TITLE = 16  # pixels of the title strip above a panel


def _to_numpy_image(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def upsample_nearest(heatmap: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of a [h, w] map to [height, width]: output
    row i reads row i * h // height (the harnesses' token grid -> label
    resolution)."""
    h, w = heatmap.shape
    rows = (np.arange(height) * h // height).clip(0, h - 1)
    cols = (np.arange(width) * w // width).clip(0, w - 1)
    return heatmap[rows][:, cols]


def overlay_heatmap_on_image(heatmap: np.ndarray, image, alpha: float = 0.6,
                             cmap: str = "plasma"):
    """Blend a [h, w] heatmap, min-max normalised and coloured, over an RGB
    image -> PIL image."""
    import PIL.Image

    img = _to_numpy_image(image)
    hm = upsample_nearest(np.asarray(heatmap, np.float64), img.shape[0], img.shape[1])
    lo, hi = hm.min(), hm.max()
    hm = (hm - lo) / (hi - lo if hi > lo else 1.0)
    colored = (colormaps.apply(cmap, hm) * 255).astype(np.float64)
    blended = (alpha * colored + (1 - alpha) * img[..., :3]).astype(np.uint8)
    return PIL.Image.fromarray(blended)


def _colour_panel(values: np.ndarray, lo: float, hi: float, cmap: str) -> np.ndarray:
    """A [h, w] map scaled by [lo, hi] (matplotlib's Normalize), coloured,
    resized nearest to a PANEL-square uint8 RGB panel."""
    x = (np.asarray(values, np.float64) - lo) / (hi - lo if hi > lo else 1.0)
    rgb = (colormaps.apply(cmap, x) * 255).astype(np.uint8)
    rows = upsample_nearest(np.arange(rgb.shape[0])[:, None], PANEL, 1)[:, 0]
    cols = upsample_nearest(np.arange(rgb.shape[1])[None, :], 1, PANEL)[0]
    return rgb[rows][:, cols]


def _figure(panels: Sequence[np.ndarray], titles: Sequence[str], save_path: Optional[str]):
    """Panels side by side under their titles, on white -> PIL image, or
    saved to `save_path` (None is returned then)."""
    import PIL.Image
    import PIL.ImageDraw

    fig = PIL.Image.new("RGB", (sum(p.shape[1] for p in panels), TITLE + PANEL), "white")
    draw = PIL.ImageDraw.Draw(fig)
    x = 0
    for panel, title in zip(panels, titles):
        fig.paste(PIL.Image.fromarray(panel), (x, TITLE))
        draw.text((x + 4, 2), title, fill="black")
        x += panel.shape[1]
    if save_path:
        fig.save(save_path)
        return None
    return fig


def plot_concept_heatmaps(image, heatmaps: np.ndarray, concepts: Sequence[str],
                          save_path: Optional[str] = None, cmap: str = "plasma"):
    """The image, then one panel per concept (or method), the maps on one
    shared colour scale."""
    import PIL.Image

    img = PIL.Image.fromarray(_to_numpy_image(image)[..., :3]).resize((PANEL, PANEL),
                                                                       PIL.Image.BILINEAR)
    lo, hi = float(np.min(heatmaps)), float(np.max(heatmaps))
    panels = [np.asarray(img)] + [_colour_panel(heatmaps[i], lo, hi, cmap)
                                  for i in range(len(concepts))]
    return _figure(panels, ["image", *concepts], save_path)


def plot_coefficients_heatmap(coefficients: np.ndarray, save_path: Optional[str] = None,
                              cmap: str = "viridis"):
    """One coefficient map beside its colour bar (max at the top), titled
    with the map's range."""
    c = np.asarray(coefficients, np.float64)
    lo, hi = float(c.min()), float(c.max())
    bar = _colour_panel(np.linspace(hi, lo, PANEL)[:, None], lo, hi, cmap)[:, : PANEL // 8]
    return _figure([_colour_panel(c, lo, hi, cmap), bar], [f"min {lo:.3g}  max {hi:.3g}", ""],
                   save_path)
