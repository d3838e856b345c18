"""PascalVOC multi-class zero-shot segmentation harness on the port.

Counterpart of the JAX package's `experiments/pascal_voc_segmentation/
run_multi_class_seg_experiment.py`, with its flags, protocol and prints: the
whole split; each image's concepts are the background concepts, then the
classes present in it; the per-token argmax maps back to VOC class ids (any
background concept to 0); per-image mIoU over the classes with a nonzero
union, running dataset mIoU and pixel accuracy (the border / ignore label
255 stays in the labels and scores as an error); layers 14..18.

    python -m conceptattention_torch.experiments.voc_multi_class \\
        --voc_root /data/VOC2012 --model_name flux-schnell

The dataset is not in the repository. `--device` is "cuda" unless another is
asked for (`--device cpu --dtype float32` on the CPU).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence, Tuple

import numpy as np

from conceptattention_torch.experiments.imagenet_segmentation import BACKGROUND_CONCEPTS


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--voc_root", required=True)
    parser.add_argument("--model_name", default="flux-schnell")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--label_size", type=int, default=224)
    parser.add_argument("--num_steps", type=int, default=4)
    parser.add_argument("--noise_timestep", type=int, default=2)
    parser.add_argument("--layers", type=int, nargs="+", default=list(range(14, 19)))
    parser.add_argument("--num_images", type=int, default=None)
    parser.add_argument("--background_concepts", nargs="+", default=BACKGROUND_CONCEPTS)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return parser.parse_args(argv)


def run(model, dataset, ids: Sequence[str], n: int, label_size: int = 224,
        background_concepts: Sequence[str] = BACKGROUND_CONCEPTS) -> Tuple[float, float]:
    """Segment and score images 0 .. n - 1 of `dataset` (a sequence of
    (image, class mask, present class names); `ids` names them in the
    prints). Returns (mIoU, pixAcc) over the images scored."""
    from conceptattention_torch.evals.datasets import VOC_CLASSES, resize_mask_nearest
    from conceptattention_torch.evals.metrics import batch_pix_accuracy
    from conceptattention_torch.utils.plotting import upsample_nearest

    bg = list(background_concepts)
    n_voc = len(VOC_CLASSES) + 1  # with the background
    total_inter, total_union = np.zeros(n_voc), np.zeros(n_voc)
    total_correct = total_label = 0
    done = 0
    for i in range(n):
        image, gt_mask, present = dataset[i]
        if not present:  # background only: nothing to segment
            continue
        done += 1
        caption = ",".join(f"a {c}" for c in present)
        pred_tokens, _ = model.segment_multi_class(image, bg + present, caption)
        pred = upsample_nearest(pred_tokens.astype(np.float64), label_size, label_size
                                ).astype(np.int64)
        remapped = np.zeros_like(pred)
        for j, cname in enumerate(present):
            remapped[pred == len(bg) + j] = VOC_CLASSES.index(cname) + 1
        label = resize_mask_nearest(gt_mask.astype(np.int64), label_size, label_size)
        correct, labeled = batch_pix_accuracy(remapped, label)
        total_correct += correct
        total_label += labeled
        img_miou, img_classes = 0.0, 0
        for c in range(n_voc):
            inter = int(np.sum((remapped == c) & (label == c)))
            union = int(np.sum((remapped == c) | (label == c)))
            total_inter[c] += inter
            total_union[c] += union
            if union:
                img_classes += 1
                img_miou += inter / union
        img_miou /= img_classes + 1e-6
        nz = total_union > 0
        run_miou = float(np.mean(total_inter[nz] / total_union[nz]))
        pix_acc = total_correct / (total_label + 1e-6)
        print(f"[{done}] {ids[i]}: img mIoU {img_miou:.4f} running mIoU {run_miou:.4f} "
              f"pixAcc {pix_acc:.4f}", flush=True)
    nz = total_union > 0
    return float(np.mean(total_inter[nz] / total_union[nz])), total_correct / (total_label + 1e-6)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.datasets import VOCMultiClassSegmentation
    from conceptattention_torch.evals.segmentation import FluxMultiClassSegmentationModel

    args = parse_args(argv)
    if not VOCMultiClassSegmentation.available(args.voc_root):
        print(f"VOC dataset not found at {args.voc_root}", file=sys.stderr)
        return 2
    dataset = VOCMultiClassSegmentation(args.voc_root)
    pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=getattr(torch, args.dtype),
                                        device=args.device)
    model = FluxMultiClassSegmentationModel(
        pipe, tap="output", num_steps=args.num_steps, noise_timestep=args.noise_timestep,
        layer_indices=args.layers, width=args.width, height=args.width,
    )
    n = len(dataset) if args.num_images is None else min(args.num_images, len(dataset))
    miou, pix_acc = run(model, dataset, dataset.ids, n, args.label_size,
                        args.background_concepts)
    print(f"FINAL mIoU {miou:.4f} pixAcc {pix_acc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
