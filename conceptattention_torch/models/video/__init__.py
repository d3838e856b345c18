"""CogVideoX video DiT and 3D causal VAE."""
