"""Per-layer sweep of segmentation quality over the double blocks.

Counterpart of the JAX package's `experiments/per_layer_segmentation/
test_segmentations_per_layer.py`, with its flags, concepts ([target,
"background", "floor", "sky"]), prints and CSV (`layer,pix_acc,miou`): ONE
`per_layer_coefficients` forward per image yields every double block's
maps; each layer's target map is thresholded at its mean, upsampled
nearest-neighbour to the labels and scored.

    python -m conceptattention_torch.experiments.per_layer_segmentation \\
        --mat_path /data/gtsegs_ijcv.mat --num_images 50 [--plot]

The dataset is not in the repository. `--device` is "cuda" unless another
is asked for (`--device cpu --dtype float32` on the CPU). `run` takes a
model and a dataset (any sequence of (image, mask, name)).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from conceptattention_torch.experiments.imagenet_segmentation import target_of

SWEEP_BACKGROUND = ["background", "floor", "sky"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mat_path", required=True)
    parser.add_argument("--model_name", default="flux-schnell")
    parser.add_argument("--tap", default="output")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--label_size", type=int, default=224)
    parser.add_argument("--num_steps", type=int, default=4)
    parser.add_argument("--noise_timestep", type=int, default=2)
    parser.add_argument("--num_images", type=int, default=50)
    parser.add_argument("--output_csv", default="per_layer_metrics.csv")
    parser.add_argument("--plot", action="store_true",
                        help="also write <output_csv>.png, a line plot")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return parser.parse_args(argv)


def label_of(gt_mask, label_size: int) -> np.ndarray:
    """The ground truth as {0, 1} at label_size^2, nearest-neighbour."""
    from conceptattention_torch.utils.plotting import upsample_nearest

    return (upsample_nearest((np.asarray(gt_mask) > 0).astype(np.float64), label_size,
                             label_size) > 0.5).astype(np.int64)


def new_stats() -> Dict[str, object]:
    return dict(correct=0, labeled=0, inter=np.zeros(2), union=np.zeros(2))


def score_mask(stats, mask, label: np.ndarray) -> None:
    """Add a binary token-grid mask, upsampled to the label's size, into
    `stats` (pixel accuracy and per-class intersection and union)."""
    from conceptattention_torch.evals.metrics import batch_intersection_union, batch_pix_accuracy
    from conceptattention_torch.utils.plotting import upsample_nearest

    pred = (upsample_nearest(np.asarray(mask, np.float64), *label.shape) > 0.5).astype(np.int64)
    correct, labeled = batch_pix_accuracy(pred, label)
    inter, union = batch_intersection_union(pred, label, 2)
    stats["correct"] += correct
    stats["labeled"] += labeled
    stats["inter"] += inter
    stats["union"] += union


def metrics(stats) -> Tuple[float, float]:
    """(pixel accuracy, mIoU) of accumulated stats."""
    return (stats["correct"] / max(stats["labeled"], 1),
            float(np.mean(stats["inter"] / np.maximum(stats["union"], 1))))


def write_csv(path: str, x_col: str, rows: Sequence[Tuple[int, float, float]]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([x_col, "pix_acc", "miou"])
        writer.writerows(rows)
    print(f"wrote {path}")


def run(model, dataset, n: int, label_size: int = 224) -> List[Tuple[int, float, float]]:
    """Images 0 .. n-1 of `dataset` through `model.per_layer_coefficients`
    (a `FluxTapSegmentationModel`): one forward an image, every double
    block's target map scored. Returns [(layer, pix_acc, miou)]."""
    depth = model.pipe.cfg.depth
    stats = [new_stats() for _ in range(depth)]
    for i in range(n):
        image, gt_mask, name = dataset[i]
        target = target_of(name)
        coeffs = model.per_layer_coefficients(image, [target, *SWEEP_BACKGROUND], target)
        label = label_of(gt_mask, label_size)
        for layer in range(depth):
            cmap = coeffs[layer, 0]  # the target concept is index 0
            score_mask(stats[layer], cmap > cmap.mean(), label)
        print(f"[{i + 1}/{n}] {name}", flush=True)
    return [(layer, *metrics(s)) for layer, s in enumerate(stats)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.datasets import ImagenetSegmentation
    from conceptattention_torch.evals.segmentation import FluxTapSegmentationModel

    args = parse_args(argv)
    if not ImagenetSegmentation.available(args.mat_path):
        print(f"dataset not found at {args.mat_path}", file=sys.stderr)
        return 2
    dataset = ImagenetSegmentation(args.mat_path)
    pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=getattr(torch, args.dtype),
                                        device=args.device)
    model = FluxTapSegmentationModel(
        pipe, tap=args.tap, num_steps=args.num_steps, noise_timestep=args.noise_timestep,
        width=args.width, height=args.width)
    rows = run(model, dataset, min(args.num_images, len(dataset)), args.label_size)
    write_csv(args.output_csv, "layer", rows)
    if args.plot:
        from conceptattention_torch.utils.sweep_plots import plot_sweep_csv

        png = os.path.splitext(args.output_csv)[0] + ".png"
        print("wrote", plot_sweep_csv(args.output_csv, png, x_col="layer",
                                      title="Layer vs Segmentation Performance"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
