"""The qualitative side by side of the segmentation baselines on one image.

Counterpart of the JAX package's
`experiments/qualitative_baseline_comparison/compare_methods.py`, with its
flags and prints: any subset of the 15 names of `evals/model_zoo.MODEL_CHOICES`
(or `all`), each built by `build_segmentation_model`, maps one image; each
method's map of the target concept is resized nearest to `--map_size` and
drawn in one figure row (`utils/plotting.plot_concept_heatmaps`), with
`--hard_masks` also its mean-thresholded mask. The flux methods share one
`ConceptAttentionFluxPipeline` (the caller's, or one built from
`--model_name`), and each runs one stopped forward.

    python -m conceptattention_torch.experiments.compare_methods \\
        --image photo.png --caption "a dog on the grass" --concepts dog grass sky \\
        --methods all --random_weights

Checkpoints come from the zoo's environment variables (CHEFER_VITB16,
DINO_VITB16, SD2_UNET, SDXL_UNET, OPENCLIP_VITH14; the flux pipeline's
FLUX_SCHNELL / FLUX_DEV and AE). `--random_weights --tiny --device cpu
--dtype float32 --model_name flux-tiny` is the smoke mode on the CPU: every
family at seconds scale with seeded random weights. `--device` is "cuda"
unless another is asked for.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np

from conceptattention_torch.evals.model_zoo import FLUX_MODELS, MODEL_CHOICES


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--image", required=True)
    parser.add_argument("--caption", default="a photo")
    parser.add_argument("--concepts", nargs="+", required=True)
    parser.add_argument("--target", default=None)
    parser.add_argument("--methods", nargs="+", default=list(FLUX_MODELS),
                        help=f"method names from {MODEL_CHOICES}, or 'all'")
    parser.add_argument("--model_name", default="flux-schnell",
                        help="flux config of the tap methods")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--map_size", type=int, default=64,
                        help="every map is resized nearest to this grid for the figure "
                        "(the methods' native resolutions differ)")
    parser.add_argument("--hard_masks", action="store_true",
                        help="also draw each method's mean-thresholded binary mask")
    parser.add_argument("--random_weights", action="store_true",
                        help="seeded random weights for the non-flux baselines (a smoke run: "
                        "the saliency is meaningless)")
    parser.add_argument("--tiny", action="store_true", help="tiny per-family configs (smoke)")
    parser.add_argument("--output", default="method_comparison.png")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                        help="the flux pipeline's dtype; the other baselines run in f32")
    args = parser.parse_args(argv)
    if args.methods == ["all"]:
        args.methods = list(MODEL_CHOICES)
    return args


def build_method(name: str, args: argparse.Namespace, pipe):
    """One SegmentationModel: the flux taps on `pipe`, the rest from their
    checkpoints or seeded random weights on `args.device`."""
    from conceptattention_torch.evals.model_zoo import build_segmentation_model

    if name in FLUX_MODELS:
        kwargs = dict(width=args.width, height=args.width)
        if args.tiny:
            kwargs.update(num_steps=2, noise_timestep=1)
        return build_segmentation_model(name, pipeline=pipe, **kwargs)
    extra = {"latent_size": 8} if name in ("DAAMSD2", "DAAMSDXL") and args.tiny else {}
    return build_segmentation_model(name, random_weights=args.random_weights, tiny=args.tiny,
                                    device=args.device, **extra)


def _resize_map(arr: np.ndarray, size: int) -> np.ndarray:
    """[h, w] map -> [size, size], PIL's nearest resize."""
    import PIL.Image

    img = PIL.Image.fromarray(np.asarray(arr, np.float32))
    return np.asarray(img.resize((size, size), PIL.Image.NEAREST))


def main(argv: Optional[Sequence[str]] = None, pipeline=None) -> int:
    """Run the comparison; `pipeline` is the caller's flux pipeline for the
    tap methods (one is built from --model_name when None)."""
    args = parse_args(argv)
    unknown = sorted(set(args.methods) - set(MODEL_CHOICES))
    if unknown:
        raise SystemExit(f"unknown methods {unknown}; choose from {MODEL_CHOICES}")
    target = args.target or args.concepts[0]
    if target not in args.concepts:
        raise SystemExit(f"--target {target!r} is not one of --concepts {args.concepts}")

    import PIL.Image

    from conceptattention_torch.utils.plotting import plot_concept_heatmaps

    image = np.asarray(PIL.Image.open(args.image).convert("RGB"))
    pipe = pipeline
    if pipe is None and any(m in FLUX_MODELS for m in args.methods):
        import torch

        from conceptattention_torch import ConceptAttentionFluxPipeline

        pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=getattr(torch, args.dtype),
                                            device=args.device)

    rows, labels = [], []
    idx = args.concepts.index(target)
    for name in args.methods:
        model = build_method(name, args, pipe)
        t0 = time.perf_counter()
        coeff, _ = model.segment_individual_image(image, args.concepts, args.caption)
        seconds = time.perf_counter() - t0
        soft = _resize_map(np.asarray(coeff)[idx], args.map_size)
        rows.append(soft)
        labels.append(name)
        print(f"{name}: coeff range [{soft.min():.3f}, {soft.max():.3f}] seconds {seconds:.4f}",
              flush=True)
        if args.hard_masks:
            rows.append((soft >= soft.mean()).astype(np.float32))
            labels.append(f"{name} mask")
        del model  # release this family's weights before the next is built

    plot_concept_heatmaps(image, np.stack(rows), labels, save_path=args.output)
    print(f"wrote {args.output} ({len(args.methods)} methods)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
