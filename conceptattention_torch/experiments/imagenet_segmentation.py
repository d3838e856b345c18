"""ImageNet-Segmentation zero-shot evaluation harness on the port.

Counterpart of the JAX package's `experiments/imagenet_segmentation/
run_experiment.py`, with its flags, protocol and prints: 512^2 input, 224^2
labels, token-grid maps upsampled nearest-neighbour, mean-value threshold,
layers 14..17, noise timestep 2 of 4; pixAcc / mIoU / mAP over the stacked
{background, foreground} pair, running prints `[i/n] name: ...`, a JSON
state that resumes an interrupted run, and a `FINAL` line. Only the Flux tap
models are ported (RawOutputSpace, RawCrossAttention, RawValueSpace,
DAAMFlux).

    python -m conceptattention_torch.experiments.imagenet_segmentation \\
        --mat_path /data/gtsegs_ijcv.mat --model_name flux-schnell --num_images 100

The dataset (`gtsegs_ijcv.mat`) is not in the repository. `--device` is
"cuda" unless another is asked for (`--device cpu --dtype float32` on the
CPU). `score_one`, `image_groups` and `run` take a model and a dataset (any
sequence of (image, mask, name)), so a caller can drive the protocol on data
held in memory.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np

FLUX_MODELS = ("RawOutputSpace", "RawCrossAttention", "RawValueSpace", "DAAMFlux")
BACKGROUND_CONCEPTS = ["background", "floor", "grass", "tree", "sky"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mat_path", required=True)
    parser.add_argument("--model_name", default="flux-schnell")
    parser.add_argument("--segmentation_model", default=None,
                        help="RawOutputSpace, RawCrossAttention, RawValueSpace or DAAMFlux; "
                        "default: the flux tap of --tap. The other baselines are not ported.")
    parser.add_argument("--random_weights", action="store_true",
                        help="the non-flux baselines' checkpoint-free run (not ported)")
    parser.add_argument("--tap", default="output", choices=["output", "cross_attention", "value"])
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--label_size", type=int, default=224)
    parser.add_argument("--num_steps", type=int, default=4)
    parser.add_argument("--noise_timestep", type=int, default=2)
    parser.add_argument("--layers", type=int, nargs="+", default=list(range(14, 18)))
    parser.add_argument("--softmax", action="store_true")
    parser.add_argument("--apply_blur", action="store_true")
    parser.add_argument("--concept_cross_attention", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--concept_self_attention", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--downscale", type=int, default=None,
                        help="score the soft coefficients (the mAP input) at NxN granularity; "
                        "the binary mask keeps its full resolution")
    parser.add_argument("--num_images", type=int, default=None)
    parser.add_argument("--image_batch", type=int, default=1,
                        help="flux taps only: encode and run this many images in one stopped "
                        "forward (segment_batch); an image whose concept list has another "
                        "length starts a new batch")
    parser.add_argument("--background_concepts", nargs="+", default=BACKGROUND_CONCEPTS)
    parser.add_argument("--state_path", default=None,
                        help="JSON state of the running metrics; an interrupted run resumes "
                        "from the next image")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return parser.parse_args(argv)


def check_segmentation_model(name: Optional[str]) -> None:
    if name is not None and name not in FLUX_MODELS:
        raise NotImplementedError(
            f"segmentation model {name!r} is not ported: the port runs the flux taps "
            f"{FLUX_MODELS}; the baseline zoo is ROADMAP.md Queue 1 item 7")


def concepts_for(target: str, background_concepts: Sequence[str]) -> List[str]:
    """The target first, then the background concepts other than it."""
    return [target] + [c for c in background_concepts if c != target]


def target_of(name: str) -> str:
    """The class word of an ImageNet-Seg name ("golden-retriever_123")."""
    return name.split("_")[0].replace("-", " ")


def build_model(args: argparse.Namespace):
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.segmentation import (
        DAAMFluxSegmentationModel,
        FluxTapSegmentationModel,
    )

    pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=getattr(torch, args.dtype),
                                        device=args.device)
    common = dict(num_steps=args.num_steps, noise_timestep=args.noise_timestep,
                  layer_indices=args.layers, width=args.width, height=args.width)
    if args.segmentation_model == "DAAMFlux":
        return DAAMFluxSegmentationModel(pipe, **common)
    tap = {"RawOutputSpace": "output", "RawCrossAttention": "cross_attention",
           "RawValueSpace": "value"}.get(args.segmentation_model, args.tap)
    return FluxTapSegmentationModel(
        pipe, tap=tap, softmax=args.softmax,
        concept_cross_attention=args.concept_cross_attention,
        concept_self_attention=args.concept_self_attention, **common)


def score_one(st, i: int, n: int, name: str, gt_mask, mask, coeff, label_size: int = 224,
              downscale: Optional[int] = None, state_path: Optional[str] = None) -> bool:
    """Score image i's mask and coefficients into `st`, print the running
    line and save the state. Returns True when the coefficient map was
    constant (scored as all background)."""
    from conceptattention_torch.evals.metrics import (
        batch_intersection_union,
        batch_pix_accuracy,
        get_ap_scores,
    )
    from conceptattention_torch.utils.plotting import upsample_nearest

    # Min-max rescale of the soft coefficients before AP: get_ap_scores
    # flattens the {bg = 1 - c, fg = c} channels together, so the scale of
    # the map changes the ordering across channels, and so mAP.
    c = np.asarray(coeff, np.float64)
    denom = c.max() - c.min()
    constant = not denom > 0
    if constant:
        print(f"WARNING: constant coefficient map for image {i} ({name}); scoring as "
              "all-background", flush=True)
        c = np.zeros_like(c)
    else:
        c = (c - c.min()) / denom
    if downscale:
        c = upsample_nearest(c, downscale, downscale)
    label = (gt_mask > 0).astype(np.int64)
    if label.shape != (label_size, label_size):
        label = (upsample_nearest(label.astype(np.float64), label_size, label_size) > 0.5
                 ).astype(np.int64)
    pred = (upsample_nearest(np.asarray(mask, np.float64), label_size, label_size) > 0.5
            ).astype(np.int64)
    coeff_label = upsample_nearest(c, label_size, label_size)
    # The stacked {bg, fg} pair is scored: for IoU the pair is another
    # statistic than the foreground map alone.
    pred_pair = np.stack([1 - pred, pred])
    label_pair = np.stack([1 - label, label])
    correct, labeled = batch_pix_accuracy(pred_pair, label_pair)
    inter, union = batch_intersection_union(pred_pair, label_pair, nclass=2)
    soft = np.stack([1.0 - coeff_label, coeff_label])[None]
    st.update(correct, labeled, inter, union, get_ap_scores(soft, label[None]), i + 1)
    print(f"[{i + 1}/{n}] {name}: {st.summary()}", flush=True)
    st.save(state_path)
    return constant


def image_groups(dataset, start: int, n: int, image_batch: int,
                 background_concepts: Sequence[str] = BACKGROUND_CONCEPTS):
    """Consecutive images [start, n) in groups of up to `image_batch` that
    share a concept-list length: lists of (i, name, gt_mask, image,
    concepts, target)."""
    i = start
    while i < n:
        group = []
        while i < n and len(group) < image_batch:
            image, gt_mask, name = dataset[i]
            target = target_of(name)
            concepts = concepts_for(target, background_concepts)
            if group and len(concepts) != len(group[0][4]):
                break
            group.append((i, name, gt_mask, image, concepts, target))
            i += 1
        yield group


def run(model, dataset, st, n: int, image_batch: int = 1, label_size: int = 224,
        background_concepts: Sequence[str] = BACKGROUND_CONCEPTS, apply_blur: bool = False,
        downscale: Optional[int] = None, state_path: Optional[str] = None):
    """Segment and score images st.next_index .. n - 1 of `dataset` into the
    SegEvalState `st`; returns it."""
    from conceptattention_torch.evals.segmentation import FluxTapSegmentationModel

    batched = image_batch > 1 and type(model) is FluxTapSegmentationModel
    if image_batch > 1 and not batched:
        print("WARNING: --image_batch applies only to the flux taps "
              "(RawOutputSpace/RawCrossAttention/RawValueSpace); running per-image", flush=True)
    constant_maps = 0
    for group in image_groups(dataset, st.next_index, n, image_batch if batched else 1,
                              background_concepts):
        if batched:
            masks, coeffs, _ = model.segment_batch(
                [g[3] for g in group], target_concepts=[g[5] for g in group],
                concepts_list=[g[4] for g in group], captions=[g[5] for g in group],
                apply_blur=apply_blur,
            )
        else:
            (_, _, _, image, concepts, target), = group
            masks, coeffs, _ = model([image], target_concepts=[target], concepts=concepts,
                                     captions=[target], apply_blur=apply_blur)
        for (i, name, gt_mask, *_), mask, coeff in zip(group, masks, coeffs):
            constant_maps += score_one(st, i, n, name, gt_mask, mask, coeff, label_size,
                                       downscale, state_path)
    if constant_maps:
        print(f"WARNING: {constant_maps} constant coefficient map(s) were scored as "
              "all-background")
    return st


def main(argv: Optional[Sequence[str]] = None) -> int:
    from conceptattention_torch.evals.datasets import ImagenetSegmentation
    from conceptattention_torch.utils.eval_state import SegEvalState

    args = parse_args(argv)
    check_segmentation_model(args.segmentation_model)
    if not ImagenetSegmentation.available(args.mat_path):
        print(f"dataset not found at {args.mat_path}", file=sys.stderr)
        return 2
    dataset = ImagenetSegmentation(args.mat_path)
    model = build_model(args)
    st = SegEvalState.load(args.state_path)
    n = len(dataset) if args.num_images is None else min(args.num_images, len(dataset))
    run(model, dataset, st, n, args.image_batch, args.label_size, args.background_concepts,
        args.apply_blur, args.downscale, args.state_path)
    print(f"FINAL {st.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
