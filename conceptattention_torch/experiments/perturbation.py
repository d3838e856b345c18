"""The positive / negative perturbation AUC of the 7 Chefer methods on the port.

Counterpart of the JAX package's `experiments/perturbation/run_experiment.py`,
with its flags, prints and CSV columns: for each explanation method, mask the
top fraction of pixels (the most relevant first for the positive test, the
least relevant first for the negative one) at steps 0.1 to 0.9, classify
again, and report the accuracy AUC. Faithful explanations have a low
positive AUC and a high negative one.

    python -m conceptattention_torch.experiments.perturbation \\
        --imagenet_dir /data/imagenet/val --num_images 500 \\
        --methods transformer_attribution gradcam rollout

Weights: `--ckpt` (a ViT-B/16 `.safetensors` for `convert_vit_state_dict`)
or the CHEFER_VITB16 environment variable; random weights otherwise (a
smoke run: the AUCs are meaningless). The ImageNet images are not in the
repository. `--device` is "cuda" unless another is asked for; the ViT runs
in f32 with TF32 off. `run` takes the weights and batches held in memory.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--imagenet_dir", required=True,
                        help="ImageFolder layout: root/<class_dir>/<image>")
    parser.add_argument("--methods", nargs="+", default=None,
                        help="a subset of the 7 Chefer methods (default: all)")
    parser.add_argument("--num_images", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--vis_class", default="top", choices=["top", "target"],
                        help="the class explained: the predicted one or the label")
    parser.add_argument("--ckpt", default=os.environ.get("CHEFER_VITB16",
                                                         os.environ.get("VIT_B16", "")))
    parser.add_argument("--image_size", type=int, default=224)
    # ViT architecture (ViT-B/16 by default)
    parser.add_argument("--vit_depth", type=int, default=12)
    parser.add_argument("--vit_hidden", type=int, default=768)
    parser.add_argument("--vit_heads", type=int, default=12)
    parser.add_argument("--vit_patch", type=int, default=16)
    parser.add_argument("--vit_classes", type=int, default=1000)
    parser.add_argument("--output_csv", default="perturbation_auc.csv")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def run(params, cfg, batches, methods: Sequence[str], vis_class: str = "top") -> List[list]:
    """The CSV rows [method, mode, auc, acc@0.1 .. acc@0.9] of `methods` over
    `batches` of (preprocessed images [B, 3, S, S], labels [B]) on the
    parameters' device; the accuracies are weighted by batch size."""
    import torch

    from conceptattention_torch.evals import perturbation as pert
    from conceptattention_torch.models.vit import vit_forward
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    @_full_f32()
    def classify(x):
        return vit_forward(params, cfg, x)[0]

    device = params["cls_token"].device
    fill = torch.from_numpy(-IMAGENET_MEAN / IMAGENET_STD).to(device)
    rows = []
    for method in methods:
        accs: Dict[bool, list] = {False: [], True: []}
        weights = []
        for x, labels in batches:
            rel = pert.compute_vit_relevance(params, cfg, x, method,
                                             index=labels if vis_class == "target" else None)
            if rel.shape[-1] != x.shape[-1]:  # token map -> pixel map
                rel = pert.upsample_token_relevance(rel, x.shape[-1])
            for negative in (False, True):
                res = pert.run_perturbation_eval(classify, x, labels, rel, negative=negative,
                                                 fill=fill)
                accs[negative].append(res.accuracy)
            weights.append(x.shape[0])
        w = np.asarray(weights, np.float64)[:, None]
        for negative in (False, True):
            acc = (np.stack(accs[negative]) * w).sum(0) / w.sum()
            trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
            auc = float(trapezoid(acc, np.linspace(0.1, 0.9, 9)))
            mode = "negative" if negative else "positive"
            rows.append([method, mode, auc] + [float(a) for a in acc])
            print(f"{method:26s} {mode:8s} AUC {auc:.4f}", flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from conceptattention_torch.evals.baselines import _preprocess
    from conceptattention_torch.evals.imagenet_data import ImageNetFolder
    from conceptattention_torch.evals.perturbation import CHEFER_METHODS
    from conceptattention_torch.models.vit import ViTConfig, init_vit_params
    from conceptattention_torch.utils.data import PrefetchIterator, batched_indices

    args = parse_args(argv)
    methods = args.methods or list(CHEFER_METHODS)
    bad = [m for m in methods if m not in CHEFER_METHODS]
    if bad:
        print(f"unknown methods {bad}; choose from {list(CHEFER_METHODS)}", file=sys.stderr)
        return 2
    dataset = ImageNetFolder(args.imagenet_dir)
    n = min(args.num_images, len(dataset))
    cfg = ViTConfig(image_size=args.image_size, patch_size=args.vit_patch,
                    hidden_size=args.vit_hidden, depth=args.vit_depth,
                    num_heads=args.vit_heads, num_classes=args.vit_classes)
    if args.ckpt:
        from conceptattention_torch.weights.convert import convert_vit_state_dict, load_safetensors

        params = convert_vit_state_dict(load_safetensors(args.ckpt), cfg, device=args.device)
    else:
        print("WARNING: no --ckpt / CHEFER_VITB16 checkpoint: random weights, the AUCs are a "
              "harness smoke test only", file=sys.stderr)
        params = init_vit_params(torch.Generator(args.device).manual_seed(0), cfg)

    def load(idx):
        imgs, labels = zip(*(dataset[i] for i in idx))
        x = torch.cat([_preprocess(im, args.image_size, args.device) for im in imgs])
        return x, torch.as_tensor(labels, device=args.device)

    batches = list(PrefetchIterator(batched_indices(n, args.batch_size), load, num_threads=4))
    rows = run(params, cfg, batches, methods, args.vis_class)
    with open(args.output_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["method", "mode", "auc"]
                        + [f"acc@{s:.1f}" for s in np.linspace(0.1, 0.9, 9)])
        writer.writerows(rows)
    print(f"wrote {args.output_csv} ({n} images, vis_class={args.vis_class})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
