"""LoRA fine-tuning quickstart: train low-rank adapters on a frozen Flux
base, export them as a `.safetensors` state dict, and reload them through
the serving pipeline.

Counterpart of the JAX package's `examples/lora_finetune.py`: the tiny
config and synthetic data by default (no checkpoints are in the repository;
`--model_name flux-schnell` with FLUX_SCHNELL=... trains the real model).
The adapters train in f32 with AdamW (optax's `adamw` defaults: weight decay
1e-4) on the plain, differentiable attention; the serving pipeline merges
them into its weights at load time, on the card in bf16 and on the CPU in
f32.

Usage: python -m conceptattention_torch.examples.lora_finetune [--steps 30] [--rank 8]
       [--device cpu]
"""

import argparse
import os
import sys
import tempfile

# Make the repo root (two levels up) importable without an install.
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))

import torch  # noqa: E402

from conceptattention_torch.config import configs  # noqa: E402
from conceptattention_torch.models.flux.params import init_flux_params, tree_map  # noqa: E402
from conceptattention_torch.ops.packing import make_img_ids  # noqa: E402
from conceptattention_torch.training import init_train_state  # noqa: E402
from conceptattention_torch.training.lora import (  # noqa: E402
    export_lora_state_dict,
    init_lora_params,
    make_lora_train_step,
)
from conceptattention_torch.weights.convert import save_safetensors  # noqa: E402


def synthetic_batch(cfg, generator, batch=4, grid=(8, 8), txt_tokens=8):
    """Stand-in for a real (packed-latent, text-embedding) dataset."""
    dev = generator.device
    p = grid[0] * grid[1]
    return {
        "img": torch.randn((batch, p, cfg.in_channels), generator=generator, device=dev),
        "img_ids": make_img_ids(*grid, batch, device=dev),
        "txt": torch.randn((batch, txt_tokens, cfg.context_in_dim), generator=generator,
                           device=dev),
        "txt_ids": torch.zeros((batch, txt_tokens, 3), device=dev),
        "y": torch.randn((batch, cfg.vec_in_dim), generator=generator, device=dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_name", default="flux-tiny")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "flux_lora.safetensors"))
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = configs[args.model_name].params
    base = init_flux_params(torch.Generator(dev).manual_seed(0), cfg, torch.float32)

    # Adapter-only optimizer state: the base never enters AdamW.
    lora = init_lora_params(torch.Generator(dev).manual_seed(1), base, rank=args.rank)
    step = make_lora_train_step(cfg, init_train_state(lora, args.lr, weight_decay=1e-4))

    for i in range(args.steps):
        batch = synthetic_batch(cfg, torch.Generator(dev).manual_seed(2_000 + i))
        loss = step(lora, base, batch, torch.Generator(dev).manual_seed(3_000 + i))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")

    # Export in the BFL-tree PEFT naming the loader understands.
    sd = export_lora_state_dict(lora)
    save_safetensors(args.out, sd)
    print(f"wrote {len(sd)} tensors to {args.out}")

    # Reload through the serving pipeline (adapters merge at load time).
    from conceptattention_torch import ConceptAttentionFluxPipeline

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    pipe = ConceptAttentionFluxPipeline(
        args.model_name, dtype=dtype, params=tree_map(lambda x: x.to(dtype), base),
        lora=args.out, device=dev,
    )
    out = pipe.generate_image(
        "a photo of a dragon", ["dragon", "sky"],
        width=64, height=64, num_inference_steps=2,
    )
    print(f"generated {out.image.size} image with "
          f"{len(out.concept_heatmaps)} concept heatmaps under the adapter")


if __name__ == "__main__":
    main()
