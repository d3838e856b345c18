"""Concept-attention video visualization.

Counterpart of the JAX package's `utils/video_utils.py`, which draws each
concept's heatmap video with matplotlib's `FuncAnimation`. The card's
machine may lack matplotlib, so here the panels are coloured with the
port's own tables (`utils/colormaps.py`, matplotlib's "plasma" and
"viridis") and GIFs are written with PIL; matplotlib is imported only for
the ffmpeg writer of another format. As in the JAX package, the concepts of
one video share one colour range (the lowest and highest value over all of
them), and a non-GIF path becomes a GIF, with a notice on stderr, when
ffmpeg is unavailable.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from conceptattention_torch.utils import colormaps


def concept_video_frames(
    heatmaps: np.ndarray,
    cmap: str = "plasma",
    scale: Optional[int] = None,
) -> np.ndarray:
    """heatmaps [C, F, h, w] -> uint8 frames [F, h * scale, C * w * scale, 3]:
    one panel per concept, side by side, each value normalized by the
    shared range as matplotlib's `imshow(vmin=lo, vmax=hi)` does, coloured
    by `colormaps.apply` and enlarged `scale` times (nearest; by default to
    about 256 pixels a side)."""
    maps = np.asarray(heatmaps, dtype=np.float32)
    c, f, h, w = maps.shape
    lo, hi = float(maps.min()), float(maps.max())
    norm = (maps - lo) / (hi - lo) if hi > lo else np.zeros_like(maps)
    rgb = colormaps.apply(cmap, norm)  # [C, F, h, w, 3] in [0, 1]
    if scale is None:
        scale = max(1, 256 // max(h, w))
    rgb = rgb.repeat(scale, axis=2).repeat(scale, axis=3)
    frames = np.concatenate(list(rgb), axis=2)  # [F, h, C * w, 3]
    return np.round(frames * 255).astype(np.uint8)


def make_concept_attention_video(
    heatmaps: np.ndarray,
    concepts: Sequence[str],
    save_path: str,
    fps: int = 8,
    cmap: str = "plasma",
) -> str:
    """heatmaps [C, F, h, w] -> one animation with a panel per concept (in
    the order of `concepts`); returns the path written."""
    if len(concepts) != np.shape(heatmaps)[0]:
        raise ValueError(f"{len(concepts)} concepts for {np.shape(heatmaps)[0]} heatmaps")
    return write_video(concept_video_frames(heatmaps, cmap), save_path, fps=fps)


def make_individual_videos(
    heatmaps: np.ndarray,
    concepts: Sequence[str],
    save_dir: str,
    fps: int = 8,
    cmap: str = "plasma",
) -> List[str]:
    """One GIF per concept, each in its own colour range; returns the paths."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for i, concept in enumerate(concepts):
        path = os.path.join(save_dir, f"{concept.replace(' ', '_')}.gif")
        paths.append(make_concept_attention_video(heatmaps[i:i + 1], [concept], path, fps, cmap))
    return paths


def _pick_writer(fps: int, save_path: str) -> Tuple[object, str]:
    """-> (writer, effective path): "pillow" for a GIF, matplotlib's
    `FFMpegWriter` for another format when ffmpeg is on the PATH; without
    ffmpeg a non-GIF path becomes the GIF beside it (with a notice) rather
    than failing after every frame is drawn."""
    if save_path.lower().endswith(".gif"):
        return "pillow", save_path
    if shutil.which("ffmpeg"):
        from matplotlib import animation

        return animation.FFMpegWriter(fps=fps), save_path
    new_path = os.path.splitext(save_path)[0] + ".gif"
    print(f"ffmpeg unavailable: writing {new_path} instead of {save_path}", file=sys.stderr)
    return "pillow", new_path


def write_video(frames: np.ndarray, save_path: str, fps: int = 8) -> str:
    """uint8 pixel frames [F, H, W, 3] -> a GIF (PIL) or, for another
    extension, an ffmpeg-written file when ffmpeg is available; returns the
    path written."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    writer, save_path = _pick_writer(fps, save_path)
    if writer == "pillow":
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(save_path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return save_path
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import animation
    from matplotlib import pyplot as plt

    fig = plt.figure(figsize=(frames.shape[2] / 72, frames.shape[1] / 72), dpi=72)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.axis("off")
    im = ax.imshow(frames[0])

    def update(i):
        im.set_data(frames[i])
        return [im]

    anim = animation.FuncAnimation(fig, update, frames=len(frames), blit=True)
    anim.save(save_path, writer=writer)
    plt.close(fig)
    return save_path
