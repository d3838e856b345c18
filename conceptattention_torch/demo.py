"""Interactive web demo (gradio) for generation and concept heatmaps.

Counterpart of the JAX package's `demo.py`: a prompt, comma-separated
concepts, width, height, steps, guidance, seed and the heatmap
normalization go to `generate_image`; the image and one heatmap per
concept come back. Gated on gradio's availability (imported when the demo is
built, so importing this module needs none of it). The pipeline runs on
`device`, the card by default, in bf16 there and in f32 on the CPU.

Run: python -m conceptattention_torch.demo [--model_name flux-schnell] [--share]
"""

from __future__ import annotations

import argparse


def build_demo(model_name: str = "flux-schnell", device: str = "cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; use the CLI instead: "
            "python -m conceptattention_torch.cli"
        ) from e
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline

    pipe = ConceptAttentionFluxPipeline(
        model_name, device=device,
        dtype=torch.bfloat16 if device.startswith("cuda") else torch.float32)
    # Model-aware defaults: guidance-distilled (flux-dev) wants ~3.5 / 50
    # steps; schnell 0.0 / 4 (the CLI's defaults).
    default_guidance = 3.5 if pipe.cfg.guidance_embed else 0.0
    default_steps = 50 if pipe.cfg.guidance_embed else 4

    def generate(prompt, concepts_text, width, height, steps, guidance, seed, norm):
        concepts = [c.strip() for c in concepts_text.split(",") if c.strip()]
        out = pipe.generate_image(
            prompt=prompt, concepts=concepts, width=int(width), height=int(height),
            num_inference_steps=int(steps), guidance=float(guidance), seed=int(seed),
            softmax=(norm == "softmax"), attention_norm=norm,
        )
        gallery = list(zip(out.concept_heatmaps, concepts))
        return out.image, gallery

    with gr.Blocks(title="ConceptAttention") as demo:
        gr.Markdown("# ConceptAttention\nGenerate an image and per-concept saliency heatmaps.")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", value="A dragon standing on a rock")
                concepts = gr.Textbox(label="Concepts (comma-separated)", value="dragon, rock, sky")
                # any 16-multiple rectangle works; the 16 step keeps values valid
                width = gr.Slider(256, 1536, value=1024, step=16, label="Width")
                height = gr.Slider(256, 1536, value=1024, step=16, label="Height")
                steps = gr.Slider(1, 50, value=default_steps, step=1, label="Steps")
                guidance = gr.Slider(0.0, 10.0, value=default_guidance, step=0.5,
                                     label="Guidance (distilled models)")
                seed = gr.Number(value=0, label="Seed")
                norm = gr.Radio(["softmax", "sparsemax", "entmax15"], value="softmax",
                                label="Heatmap normalization")
                btn = gr.Button("Generate")
            with gr.Column():
                image = gr.Image(label="Generated image")
                heatmaps = gr.Gallery(label="Concept heatmaps")
        btn.click(generate, [prompt, concepts, width, height, steps, guidance, seed, norm],
                  [image, heatmaps])
    return demo


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="flux-schnell")
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    args = parser.parse_args(argv)
    demo = build_demo(args.model_name, args.device)
    demo.launch(share=args.share, server_port=args.port)


if __name__ == "__main__":
    main()
