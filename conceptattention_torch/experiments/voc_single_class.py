"""PascalVOC single-class zero-shot segmentation harness on the port.

Counterpart of the JAX package's `experiments/pascal_voc_segmentation/
run_single_class_split_experiment.py`, with its flags, protocol and prints:
only the images with exactly one foreground class; the target concept and
the background concepts are segmented with the mean-value threshold; pixAcc
/ mIoU / mAP accumulate in a JSON state that resumes an interrupted run;
layers 14..18.

    python -m conceptattention_torch.experiments.voc_single_class \\
        --voc_root /data/VOC2012 --model_name flux-schnell

The dataset is not in the repository. `--device` is "cuda" unless another is
asked for (`--device cpu --dtype float32` on the CPU).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from conceptattention_torch.experiments.imagenet_segmentation import (
    BACKGROUND_CONCEPTS,
    concepts_for,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--voc_root", required=True)
    parser.add_argument("--model_name", default="flux-schnell")
    parser.add_argument("--tap", default="output")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--label_size", type=int, default=224)
    parser.add_argument("--num_steps", type=int, default=4)
    parser.add_argument("--noise_timestep", type=int, default=2)
    parser.add_argument("--layers", type=int, nargs="+", default=list(range(14, 19)))
    parser.add_argument("--num_images", type=int, default=None)
    parser.add_argument("--background_concepts", nargs="+", default=BACKGROUND_CONCEPTS)
    parser.add_argument("--state_path", default=None,
                        help="JSON state of the running metrics; an interrupted run resumes "
                        "from the next image")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return parser.parse_args(argv)


def run(model, dataset, st, n: int, label_size: int = 224,
        background_concepts: Sequence[str] = BACKGROUND_CONCEPTS,
        state_path: Optional[str] = None):
    """Segment and score images st.next_index .. n - 1 of `dataset` (a
    sequence of (image, class mask, class name)) into the SegEvalState
    `st`; returns it."""
    from conceptattention_torch.evals.datasets import resize_mask_nearest
    from conceptattention_torch.evals.metrics import (
        batch_intersection_union,
        batch_pix_accuracy,
        get_ap_scores,
    )
    from conceptattention_torch.utils.plotting import upsample_nearest

    for i in range(st.next_index, n):
        image, gt_mask, target = dataset[i]
        masks, coeffs, _ = model([image], target_concepts=[target],
                                 concepts=concepts_for(target, background_concepts),
                                 captions=[target])
        label = resize_mask_nearest(
            np.logical_and(gt_mask > 0, gt_mask != 255).astype(np.int64), label_size, label_size)
        pred = (upsample_nearest(masks[0].astype(np.float64), label_size, label_size) > 0.5
                ).astype(np.int64)
        coeff = upsample_nearest(coeffs[0].astype(np.float64), label_size, label_size)
        correct, labeled = batch_pix_accuracy(pred, label)
        inter, union = batch_intersection_union(pred, label, nclass=2)
        soft = np.stack([1.0 - coeff, coeff])[None]
        st.update(correct, labeled, inter, union, get_ap_scores(soft, label[None]), i + 1)
        print(f"[{i + 1}/{n}] {target}: {st.summary()}", flush=True)
        st.save(state_path)
    return st


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.datasets import VOCSingleClassSegmentation
    from conceptattention_torch.evals.segmentation import FluxTapSegmentationModel
    from conceptattention_torch.utils.eval_state import SegEvalState

    args = parse_args(argv)
    if not VOCSingleClassSegmentation.available(args.voc_root):
        print(f"VOC dataset not found at {args.voc_root}", file=sys.stderr)
        return 2
    dataset = VOCSingleClassSegmentation(args.voc_root)
    pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=getattr(torch, args.dtype),
                                        device=args.device)
    model = FluxTapSegmentationModel(
        pipe, tap=args.tap, num_steps=args.num_steps, noise_timestep=args.noise_timestep,
        layer_indices=args.layers, width=args.width, height=args.width,
    )
    st = SegEvalState.load(args.state_path)
    n = len(dataset) if args.num_images is None else min(args.num_images, len(dataset))
    run(model, dataset, st, n, args.label_size, args.background_concepts, args.state_path)
    print(f"FINAL {st.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
