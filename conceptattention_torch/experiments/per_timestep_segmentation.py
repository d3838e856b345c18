"""Per-timestep sweep of segmentation quality over the noise level.

Counterpart of the JAX package's `experiments/per_timestep_segmentation/
test_segmentations_per_time.py`, with its flags, concepts, prints and CSV
(`timestep,pix_acc,miou`): flux-dev's 50-step shifted schedule, one
`FluxTapSegmentationModel` per noise timestep (`--timesteps`, every 5th step
by default) over layers 14-17, each image's mask scored per timestep.

    python -m conceptattention_torch.experiments.per_timestep_segmentation \\
        --mat_path /data/gtsegs_ijcv.mat --num_images 25 [--plot]

The dataset is not in the repository. `--device` is "cuda" unless another
is asked for (`--device cpu --dtype float32` on the CPU). `run` takes a
pipeline and a dataset (any sequence of (image, mask, name)).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

from conceptattention_torch.experiments.imagenet_segmentation import target_of
from conceptattention_torch.experiments.per_layer_segmentation import (
    SWEEP_BACKGROUND,
    label_of,
    metrics,
    new_stats,
    score_mask,
    write_csv,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mat_path", required=True)
    parser.add_argument("--model_name", default="flux-dev")
    parser.add_argument("--tap", default="output")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--label_size", type=int, default=224)
    parser.add_argument("--num_steps", type=int, default=50)
    parser.add_argument("--timesteps", type=int, nargs="+", default=None)
    parser.add_argument("--layers", type=int, nargs="+", default=list(range(14, 18)))
    parser.add_argument("--num_images", type=int, default=25)
    parser.add_argument("--output_csv", default="per_timestep_metrics.csv")
    parser.add_argument("--plot", action="store_true",
                        help="also write <output_csv>.png, a line plot")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return parser.parse_args(argv)


def models_per_timestep(pipe, timesteps: Sequence[int], tap: str = "output",
                        num_steps: int = 50, layers: Sequence[int] = range(14, 18),
                        width: int = 512):
    """{timestep: the FluxTapSegmentationModel that noises to it}."""
    from conceptattention_torch.evals.segmentation import FluxTapSegmentationModel

    return {t: FluxTapSegmentationModel(pipe, tap=tap, num_steps=num_steps, noise_timestep=t,
                                        layer_indices=list(layers), width=width, height=width)
            for t in timesteps}


def run(models, dataset, n: int, label_size: int = 224) -> List[Tuple[int, float, float]]:
    """Images 0 .. n-1 of `dataset` through each timestep's model of
    `models` ({timestep: model}). Returns [(timestep, pix_acc, miou)]."""
    stats = {t: new_stats() for t in models}
    for i in range(n):
        image, gt_mask, name = dataset[i]
        target = target_of(name)
        label = label_of(gt_mask, label_size)
        for t, model in models.items():
            (mask,), _, _ = model([image], target_concepts=[target],
                                  concepts=[target, *SWEEP_BACKGROUND], captions=[target])
            score_mask(stats[t], mask, label)
        print(f"[{i + 1}/{n}] {name}", flush=True)
    return [(t, *metrics(s)) for t, s in stats.items()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.datasets import ImagenetSegmentation

    args = parse_args(argv)
    if not ImagenetSegmentation.available(args.mat_path):
        print(f"dataset not found at {args.mat_path}", file=sys.stderr)
        return 2
    dataset = ImagenetSegmentation(args.mat_path)
    pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=getattr(torch, args.dtype),
                                        device=args.device)
    models = models_per_timestep(pipe, args.timesteps or range(0, args.num_steps, 5), args.tap,
                                 args.num_steps, args.layers, args.width)
    rows = run(models, dataset, min(args.num_images, len(dataset)), args.label_size)
    write_csv(args.output_csv, "timestep", rows)
    if args.plot:
        from conceptattention_torch.utils.sweep_plots import plot_sweep_csv

        png = os.path.splitext(args.output_csv)[0] + ".png"
        print("wrote", plot_sweep_csv(args.output_csv, png, x_col="timestep",
                                      title="Noise Timestep vs Segmentation Performance"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
