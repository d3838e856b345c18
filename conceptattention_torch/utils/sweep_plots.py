"""Line plots of the per-layer and per-timestep sweep CSVs.

Counterpart of the JAX package's `utils/sweep_plots.py`: one axes with a
line per metric (accuracy, mIoU) against the sweep variable. Host code;
matplotlib (Agg backend) is imported only when a plot is drawn.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional

_METRIC_LABELS = {"pix_acc": "Accuracy", "miou": "mIoU", "map": "mAP"}


def read_sweep_csv(csv_path: str) -> Dict[str, List[float]]:
    """A CSV with a header row -> {column name: [floats]}."""
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [float(r[i]) for r in body] for i, name in enumerate(header)}


def plot_sweep_csv(
    csv_path: str,
    out_png: str,
    x_col: Optional[str] = None,
    title: Optional[str] = None,
) -> str:
    """Plot every metric column of a sweep CSV against `x_col` (the first
    column by default) into a PNG; returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = read_sweep_csv(csv_path)
    x_col = x_col or next(iter(cols))
    x = cols[x_col]

    fig, ax = plt.subplots(1, 1, figsize=(6 * 0.9, 4 * 0.9))
    for name, ys in cols.items():
        if name == x_col:
            continue
        ax.plot(x, ys, marker="o", label=_METRIC_LABELS.get(name, name))
    ax.set_xlabel(x_col.replace("_", " ").title())
    ax.set_ylabel("Metric")
    ax.set_title(title or f"{x_col.title()} vs Segmentation Performance")
    ax.xaxis.set_major_locator(plt.MaxNLocator(integer=True))
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
