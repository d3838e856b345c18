"""Command-line sampler: generate an image and its concept heatmaps.

Counterpart of the JAX package's `cli.py`: a one-shot sampler, or with
`--loop` an interactive one that reads prompts and concepts from standard
input (a fresh random seed after the first image). It writes the image with
EXIF provenance tags and one heatmap PNG per concept, and prints the
seconds of each image and the launches of the port's kernels it made. It
runs on `--device` (cuda by default) and raises without a card unless
`--device cpu` is asked for.

Usage:
  python -m conceptattention_torch --prompt "a dragon on a rock" \\
      --concepts dragon rock sky --width 1024 --height 1024 --output out.png
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ConceptAttention sampler (PyTorch)")
    p.add_argument("--model_name", default="flux-schnell", help="config registry key")
    p.add_argument("--prompt", default="a photo of a dragon standing on a rock")
    p.add_argument("--concepts", nargs="+", default=["dragon", "rock", "sky"])
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=None,
                   help="default: 4 (schnell) / 50 (dev)")
    p.add_argument("--guidance", type=float, default=None,
                   help="default: 3.5 for guidance-distilled models (flux-dev), else 0.0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attention_norm", default="softmax",
                   choices=["softmax", "sparsemax", "entmax15"])
    p.add_argument("--layers", type=int, nargs="+", default=None)
    p.add_argument("--output", default="output.png")
    p.add_argument("--heatmap_dir", default=None,
                   help="directory for per-concept heatmap PNGs")
    p.add_argument("--loop", action="store_true", help="interactive prompt loop")
    p.add_argument("--add_sampling_metadata", action=argparse.BooleanOptionalAction,
                   default=True, help="write the prompt into the image's EXIF metadata")
    p.add_argument("--nsfw_filter", action=argparse.BooleanOptionalAction, default=True,
                   help="screen outputs with the NSFW classifier when its checkpoint is "
                        "available")
    p.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    p.add_argument("--quantize", default=None, choices=["w8", "w8a8", "w4"],
                   help="quantized layer stacks: int8 weights (w8), int8 activations too "
                        "(w8a8), or group-wise int4 weights (w4)")
    p.add_argument("--attention_backend", default="fused", choices=["fused", "sdpa"],
                   help="fused: the flash-saliency kernels; sdpa: the plain path")
    p.add_argument("--int8_qk", action="store_true",
                   help="attention scores from int8 q and k (fused backend)")
    p.add_argument("--lora", nargs="+", default=None, metavar="PATH",
                   help="LoRA .safetensors adapter(s) merged into the DiT at load time "
                        "(BFL / kohya / diffusers-flux namings)")
    p.add_argument("--lora_strength", type=float, nargs="+", default=None,
                   help="per-adapter merge strengths (default 1.0 each)")
    return p


def _exif_for(model_name: str, prompt: str, add_sampling_metadata: bool):
    """EXIF provenance tags of a generated image."""
    from PIL import Image
    from PIL.ExifTags import Base

    exif = Image.Exif()
    exif[Base.Software] = "AI generated;txt2img;flux"
    exif[Base.Make] = "Black Forest Labs"
    exif[Base.Model] = model_name
    if add_sampling_metadata:
        exif[Base.ImageDescription] = prompt
    return exif


def run_once(pipe, args) -> None:
    from conceptattention_torch.kernels import launch_counts

    num_steps = args.num_steps or (50 if "dev" in args.model_name else 4)
    before = launch_counts()
    t0 = time.perf_counter()
    out = pipe.generate_image(
        prompt=args.prompt,
        concepts=args.concepts,
        width=args.width,
        height=args.height,
        num_inference_steps=num_steps,
        guidance=args.guidance,
        seed=args.seed,
        layer_indices=args.layers,
        softmax=(args.attention_norm == "softmax"),
        attention_norm=args.attention_norm,
    )
    dt = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    if args.nsfw_filter:
        from conceptattention_torch.utils import safety

        score = safety.nsfw_score(out.image)
        if score >= safety.NSFW_THRESHOLD:
            print("Your generated image may contain NSFW content.")
            return
        if not safety.classifier_available():
            print(f"# NSFW classifier unavailable ({safety.unavailable_reason()}); "
                  "saving unscreened")
    out.image.save(args.output, exif=_exif_for(args.model_name, args.prompt,
                                               args.add_sampling_metadata))
    print(f"wrote {args.output} in {dt:.3f}s")
    print(f"kernel launches {json.dumps(launches)}")
    heatmap_dir = args.heatmap_dir or os.path.splitext(args.output)[0] + "_heatmaps"
    os.makedirs(heatmap_dir, exist_ok=True)
    for concept, hm in zip(args.concepts, out.concept_heatmaps):
        hm.save(os.path.join(heatmap_dir, f"{concept.replace(' ', '_')}.png"))
    print(f"wrote {len(args.concepts)} heatmaps to {heatmap_dir}/", flush=True)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.width % 16 or args.height % 16:
        # fail before the model is built; any 16-multiple rectangle works
        parser.error("--width and --height must be multiples of 16")
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline

    pipe = ConceptAttentionFluxPipeline(
        args.model_name, device=args.device,
        dtype=torch.bfloat16 if args.device.startswith("cuda") else torch.float32,
        quantize=args.quantize or False, attention_backend=args.attention_backend,
        int8_qk=args.int8_qk, lora=args.lora, lora_strength=args.lora_strength or 1.0,
    )
    if args.guidance is None:
        # guidance-distilled models (flux-dev) degrade badly at guidance 0
        args.guidance = 3.5 if pipe.cfg.guidance_embed else 0.0
    if not args.loop:
        run_once(pipe, args)
        return
    first = True
    while True:
        try:
            prompt = input("prompt> ").strip()
        except EOFError:
            break
        if prompt in ("q", "quit", "exit", ""):
            break
        if not first:
            import random

            args.seed = random.randrange(2**31)
            print(f"seed: {args.seed}")
        first = False
        args.prompt = prompt
        concepts = input("concepts (space-separated)> ").strip()
        if concepts:
            args.concepts = concepts.split()
        run_once(pipe, args)


if __name__ == "__main__":
    main()
