"""The plain reference that decides `correct`.

Plain PyTorch in float32 with TF32 off, one layer at a time: the Flux DiT
with its concept stream and the rectified-flow Euler loop (`flux.py`), the
Flux VAE (`flux_vae.py`), and the CogVideoX DiT with its concept stream and
the DDIM loop (`video.py`). It imports nothing of the measured package and
nothing of the JAX package; it reads the parameter trees that the benchmark
made (`perfbench/weights.py`), in the layout the program takes, and upcasts
one layer at a time, so no float32 copy of a whole model exists. Within
`common.rounded(common.fp8)` it runs in float8: the cells' control.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """float32 matmuls and convolutions without TF32 for the scope."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
