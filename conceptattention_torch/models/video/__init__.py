"""CogVideoX video DiT and 3D causal VAE; HunyuanVideo on the Flux blocks."""
