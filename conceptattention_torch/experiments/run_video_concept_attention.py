"""Video concept-attention driver.

Counterpart of the JAX package's `experiments/video_model/
run_video_concept_attention.py`: generate a CogVideoX clip with concept
tokens and write the concepts' heatmap animation (`concepts.gif`), and with
`--decode` the decoded clip (`video.gif`), under `--output_dir`.

    python -m conceptattention_torch.experiments.run_video_concept_attention \\
        --num_steps 50 --decode

runs CogVideoX-5b (random weights, `init_seed` 0) on the card in bf16;
`--tiny` runs the JAX script's tiny CogVideoX and VAE configs (4 frames of
8x8 latents, at most 5 steps), and `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch


def tiny_configs():
    """The JAX script's `--tiny` CogVideoX and VAE configs."""
    from conceptattention_torch.models.video.dit import CogVideoXConfig
    from conceptattention_torch.models.video.vae import CogVideoXVAEConfig

    cfg = CogVideoXConfig(
        num_attention_heads=4, attention_head_dim=16, time_embed_dim=32,
        text_embed_dim=64, num_layers=2, max_text_seq_length=16,
        use_rotary_positional_embeddings=True,
    )
    vae_cfg = CogVideoXVAEConfig(
        block_out_channels=(8, 16), latent_channels=cfg.in_channels,
        layers_per_block=1, norm_num_groups=4,
    )
    return cfg, vae_cfg


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--prompt", default="a dog running through a field")
    parser.add_argument("--concepts", nargs="+", default=["dog", "grass", "sky"])
    parser.add_argument("--num_frames", type=int, default=13)
    parser.add_argument("--height", type=int, default=60, help="latent px")
    parser.add_argument("--width", type=int, default=90, help="latent px")
    parser.add_argument("--num_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=6.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", default="video_heatmaps")
    parser.add_argument("--tiny", action="store_true", help="tiny config smoke run")
    parser.add_argument(
        "--decode", action="store_true",
        help="decode latents to pixel frames through the 3D VAE and write "
             "video.gif next to the heatmaps",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.tiny:
        args.num_frames, args.height, args.width = 4, 8, 8
        args.num_steps = min(args.num_steps, 5)
    return args


def build_pipeline(args: argparse.Namespace):
    """The pipeline the flags ask for: bf16 on `--device`, CogVideoX-5b or
    the tiny configs."""
    from conceptattention_torch.models.video.dit import cogvideox_5b_config
    from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline

    cfg, vae_cfg = tiny_configs() if args.tiny else (cogvideox_5b_config(), None)
    return VideoConceptAttentionPipeline(cfg=cfg, dtype=torch.bfloat16, vae_cfg=vae_cfg,
                                         device=args.device)


def main(argv: Optional[Sequence[str]] = None, pipeline=None):
    """Run the experiment; returns the pipeline's output. `pipeline` (one
    built by `build_pipeline` or the caller) is reused when given."""
    from conceptattention_torch.utils.video_utils import make_concept_attention_video, write_video

    args = parse_args(argv)
    pipe = pipeline if pipeline is not None else build_pipeline(args)
    out = pipe.generate_video(
        prompt=args.prompt,
        concepts=args.concepts,
        num_frames=args.num_frames,
        height=args.height,
        width=args.width,
        num_inference_steps=args.num_steps,
        guidance_scale=args.guidance_scale,
        seed=args.seed,
        decode=args.decode,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    path = make_concept_attention_video(out.concept_heatmaps, args.concepts,
                                        os.path.join(args.output_dir, "concepts.gif"))
    print(f"wrote {path}; heatmaps {out.concept_heatmaps.shape}")
    if args.decode:
        vpath = write_video(out.video_frames, os.path.join(args.output_dir, "video.gif"))
        print(f"wrote {vpath}; frames {out.video_frames.shape}")
    return out


if __name__ == "__main__":
    main()
