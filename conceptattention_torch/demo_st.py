"""Streamlit demo: interactive generation, concept heatmaps, image-to-image.

Counterpart of the JAX package's `demo_st.py`: a model picker, the prompt,
image-to-image with a noising-strength slider, width / height / steps /
guidance / seed, the concepts and their normalization, NSFW screening
(`utils/safety`) and a download with the sampling parameters in its EXIF
tags (`cli._exif_for`), with the per-concept heatmap gallery. Gated on
streamlit's availability; streamlit and PIL are imported when the page
runs, so importing this module needs neither. The pipeline runs on
`--device`, the card by default, in bf16 there and in f32 on the CPU.

Run: streamlit run conceptattention_torch/demo_st.py [-- --device cpu]
"""

from __future__ import annotations

import argparse


def main(device: str = "cuda"):
    try:
        import streamlit as st
    except ImportError as e:
        raise SystemExit(
            "streamlit is not installed in this environment; use the CLI "
            "instead: python -m conceptattention_torch.cli"
        ) from e

    import numpy as np
    import PIL.Image
    import torch

    from conceptattention_torch.config import configs

    @st.cache_resource()
    def get_pipeline(name: str):
        from conceptattention_torch import ConceptAttentionFluxPipeline

        return ConceptAttentionFluxPipeline(
            name, device=device,
            dtype=torch.bfloat16 if device.startswith("cuda") else torch.float32)

    st.title("ConceptAttention")
    name = st.selectbox("Which model to load?", list(configs.keys()))
    if name is None or not st.checkbox("Load model", False):
        return
    pipe = get_pipeline(name)
    is_schnell = "schnell" in name

    do_img2img = st.checkbox("Image to Image", False)
    init_image = None
    strength = 0.8
    if do_img2img:
        uploaded = st.file_uploader("Input", type=["jpg", "jpeg", "png"])
        if uploaded is None:
            st.warning("Please add an image to do image to image")
        else:
            init_image = np.asarray(PIL.Image.open(uploaded).convert("RGB"))
            h, w = init_image.shape[:2]
            st.write(f"Got image of size {w}x{h} ({h * w / 1e6:.2f}MP)")
        strength = st.number_input(
            # strength 0 would leave no denoise steps (generate_image raises)
            "Noising strength", min_value=0.05, max_value=1.0, value=0.8
        )

    # Any 16-multiple rectangle works.
    width = 16 * (st.number_input("Width", min_value=128, value=1024, step=16) // 16)
    height = 16 * (st.number_input("Height", min_value=128, value=1024, step=16) // 16)
    num_steps = int(
        st.number_input("Number of steps", min_value=1, value=(4 if is_schnell else 50))
    )
    guidance = float(
        st.number_input("Guidance", min_value=0.0, value=(0.0 if is_schnell else 3.5),
                        disabled=is_schnell)
    )
    seed = int(st.number_input("Seed", min_value=0, value=0))
    concepts_text = st.text_input("Concepts (comma-separated)", "dragon, rock, sky")
    norm = st.selectbox("Attention norm", ["softmax", "sparsemax", "entmax15"])
    add_metadata = st.checkbox("Add sampling parameters to metadata?", True)

    prompt = st.text_input("Prompt", "a photo of a dragon standing on a rock")
    if not st.button("Sample"):
        return

    concepts = [c.strip() for c in concepts_text.split(",") if c.strip()]
    with st.spinner("Generating..."):
        out = pipe.generate_image(
            prompt=prompt,
            concepts=concepts,
            width=int(width),
            height=int(height),
            num_inference_steps=num_steps,
            guidance=guidance,
            seed=seed,
            softmax=(norm == "softmax"),
            attention_norm=norm,
            init_image=init_image,
            image2image_strength=strength if init_image is not None else 0.0,
        )

    from conceptattention_torch.utils import safety

    if not safety.is_safe(out.image):
        st.warning("Your generated image may contain NSFW content.")
        return

    st.image(out.image, caption=prompt)
    cols = st.columns(max(1, len(concepts)))
    for col, concept, hm in zip(cols, concepts, out.concept_heatmaps):
        col.image(hm, caption=concept)

    if add_metadata:
        import io

        from conceptattention_torch.cli import _exif_for

        buf = io.BytesIO()
        out.image.save(buf, format="PNG", exif=_exif_for(name, prompt, True))
        st.download_button("Download (with EXIF)", buf.getvalue(),
                           file_name="concept_attention.png", mime="image/png")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    main(**vars(parser.parse_args()))
