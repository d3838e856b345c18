"""Shrunken cells for the CPU tests: the program's tiny presets and small
traffic, run through the harness's whole path with the card left out."""

FLUX_TINY = {
    "port_model": "flux-tiny", "attention_head_dim": 32, "num_attention_heads": 4,
    "num_layers": 2, "num_single_layers": 2, "in_channels": 16, "joint_attention_dim": 64,
    "pooled_projection_dim": 32, "axes_dims_rope": [8, 12, 12], "t5_max_length": 16,
    "vae": {"block_out_channels": [16, 32], "layers_per_block": 1, "latent_channels": 4},
}
VIDEO_TINY = {
    "port_preset": None, "num_attention_heads": 2, "attention_head_dim": 16, "in_channels": 4,
    "out_channels": 4, "time_embed_dim": 8, "text_embed_dim": 16, "num_layers": 2,
    "max_text_seq_length": 6,
}
OVERRIDES = {
    "flux-schnell.generate-1024-b4": {
        "config": FLUX_TINY, "traffic": {"width": 64, "height": 64, "batch": 2, "steps": 2}},
    "flux-schnell.encode-512-b8": {
        "config": FLUX_TINY,
        "traffic": {"width": 64, "height": 64, "batch": 2, "pool": 4, "check_images": 4}},
    "cogvideox-5b.denoise-49f": {
        "config": VIDEO_TINY, "traffic": {"frames": 3, "height": 8, "width": 8, "steps": 2}},
}
