"""Extract concept heatmaps from a real image.

Counterpart of the JAX package's `examples/example_encoded_image.py`:
flux-schnell encodes the image (default `generated_image.png`, which
`example_generated_image.py` writes) at 1024x1024 with 4 samples, on the
card. `--device cpu --tiny` runs flux-tiny at 64x64 on the CPU.
"""

import argparse
import os
import sys

# Allow running as a plain script from anywhere: put the repo root (two
# levels up) on sys.path so `conceptattention_torch` imports without install.
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image_path", nargs="?", default="generated_image.png")
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    ap.add_argument("--tiny", action="store_true", help="flux-tiny at 64x64")
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline

    image = PIL.Image.open(args.image_path).convert("RGB")
    model_name, size = ("flux-tiny", 64) if args.tiny else ("flux-schnell", 1024)
    pipeline = ConceptAttentionFluxPipeline(
        model_name=model_name, device=args.device,
        dtype=torch.bfloat16 if args.device.startswith("cuda") else torch.float32)
    concepts = ["dragon", "rock", "sky", "cloud"]
    out = pipeline.encode_image(
        image=image,
        concepts=concepts,
        prompt="A dragon standing on a rock",
        width=size,
        height=size,
        num_samples=4,
    )
    for concept, heatmap in zip(concepts, out.concept_heatmaps):
        heatmap.save(f"encoded_{concept}_heatmap.png")
    print("wrote per-concept heatmaps for", args.image_path)


if __name__ == "__main__":
    main()
