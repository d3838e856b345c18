"""Int8 serving on one card: flux-schnell with w8a8 layer stacks.

Counterpart of the JAX package's `examples/int8_serving.py`.
`quantize="w8a8"` stores the DiT's layer stacks as int8 weights with
per-channel scales (quantized on the host from a checkpoint, or drawn
already quantized for a random init) and quantizes the activations per
token, so the stacks' products run int8 x int8 (`torch._int_mm`). The
attention scores stay bf16 here; `int8_qk=True` would take them from int8 q
and k as well (K1b). Two prompts go through one batched denoise
(`generate_images`) at 1024x1024, 4 steps.

Checkpoints come from the FLUX_SCHNELL and AE environment variables;
without them the model initializes randomly, which still runs the whole
serving path. `--device cpu --tiny` runs flux-tiny at 64x64 on the CPU.
"""

import argparse
import os
import sys

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
        model_name=model_name,
        device=args.device,
        dtype=torch.bfloat16 if args.device.startswith("cuda") else torch.float32,
        quantize="w8a8",  # int8 weights + dynamic int8 activations
    )
    prompt = "A dragon standing on a rock"
    concepts = ["dragon", "rock", "sky", "cloud"]
    # One batched denoise for both prompts, then one decode per image.
    outs = pipeline.generate_images(
        prompts=[prompt] * 2,
        concepts=concepts,
        width=size,
        height=size,
        seed=0,
        num_inference_steps=4,
    )
    for i, out in enumerate(outs):
        out.image.save(f"int8_image_{i}.png")
        for concept, heatmap in zip(concepts, out.concept_heatmaps):
            heatmap.save(f"int8_{i}_{concept}.png")
    print(f"wrote {len(outs)} images + {len(concepts)} heatmaps each")


if __name__ == "__main__":
    main()
