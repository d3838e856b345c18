"""Generate an image and save per-concept heatmaps.

Counterpart of the JAX package's `examples/example_generated_image.py`:
flux-schnell at 1024x1024, 4 steps, four concepts, on the card (random
weights unless FLUX_SCHNELL and AE name checkpoints). `--device cpu --tiny`
runs flux-tiny at 64x64 on the CPU.
"""

import argparse
import os
import sys

# Allow running as a plain script from anywhere: put the repo root (two
# levels up) on sys.path so `conceptattention_torch` imports without install.
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    ap.add_argument("--tiny", action="store_true", help="flux-tiny at 64x64")
    args = ap.parse_args(argv)

    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline

    model_name, size = ("flux-tiny", 64) if args.tiny else ("flux-schnell", 1024)
    pipeline = ConceptAttentionFluxPipeline(
        model_name=model_name, device=args.device,
        dtype=torch.bfloat16 if args.device.startswith("cuda") else torch.float32)
    prompt = "A dragon standing on a rock"
    concepts = ["dragon", "rock", "sky", "cloud"]
    out = pipeline.generate_image(
        prompt=prompt,
        concepts=concepts,
        width=size,
        height=size,
        seed=0,
        num_inference_steps=4,
    )
    out.image.save("generated_image.png")
    for concept, heatmap in zip(concepts, out.concept_heatmaps):
        heatmap.save(f"{concept}_heatmap.png")
    print("wrote generated_image.png and per-concept heatmaps")


if __name__ == "__main__":
    main()
