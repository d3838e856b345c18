"""Operations and bounds of the video cells that `roofline.py` does not
count: HunyuanVideo's forward (Flux's, plus embedded guidance and the token
refiner) and the CogVideoX 3D VAE's decoder, by `roofline.py`'s rules (2
operations a multiply-add; attention over the unmasked pairs; each input
read once and each output written once)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from perfbench import roofline


def refiner_flops(cfg: Dict, n: int) -> float:
    """One pass of the token refiner over n tokens, less its input
    projection (`flux_forward_flops` counts it as Flux's `txt_in`): the
    t and c embedders, and each block's modulation, qkv, attention, proj and
    SiLU MLP."""
    d, m = cfg["hidden"], cfg["mlp_hidden"]
    macs = 256 * d + d * d + cfg["context_in_dim"] * d + d * d
    macs += cfg["num_refiner_layers"] * (d * 2 * d + n * (3 * d * d + d * d + 2 * d * m))
    return 2.0 * macs + cfg["num_refiner_layers"] * 4.0 * d * n * n


def hunyuan_forward_flops(cfg: Dict, t: int, p: int, c: int) -> Dict[str, float]:
    """One HunyuanVideo forward of one clip with t valid text, p video and c
    concept tokens and only the "output" tap: {"linear", "attention",
    "maps", "refiner"} operations. `cfg`: `flux_forward_flops`'s sizes and
    num_refiner_layers."""
    d = cfg["hidden"]
    out = roofline.flux_forward_flops(cfg, 1, t, p, c)
    n_cond = 2 if c else 1
    out["linear"] += 2.0 * n_cond * (256 * d + d * d)  # guidance_in
    out["maps"] = cfg["depth"] * 2.0 * c * p * d  # the "output" tap alone
    out["refiner"] = refiner_flops(cfg, t) + (refiner_flops(cfg, c) if c else 0.0)
    return out


# ---------------------------------------------------------------- CogVideoX VAE

# (c_in, c_out, (k_t, k_h, k_w), (t, h, w) of the output)
Conv = Tuple[int, int, Tuple[int, int, int], Tuple[int, int, int]]


def cogvideox_decoder_convs(cfg: Dict, frames: int, height: int, width: int) -> List[Conv]:
    """Every convolution of one decode of [frames, height, width] latents:
    the causal 3x3x3 and 1x1x1 convs (SpatialNorm3D's two a norm, the
    shortcuts) and the upsamplers' per-frame 3x3 Conv2d (k_t 1). `cfg`:
    block_out_channels, layers_per_block, latent_channels, out_channels,
    temporal_compression_ratio."""
    zc = cfg["latent_channels"]
    chans = list(cfg["block_out_channels"])[::-1]
    in_time = int(math.log2(cfg["temporal_compression_ratio"]))
    t, h, w = frames, height, width
    convs: List[Conv] = [(zc, chans[0], (3, 3, 3), (t, h, w))]

    def norm(c):
        convs.extend([(zc, c, (1, 1, 1), (t, h, w))] * 2)

    def resnet(c_in, c_out):
        norm(c_in)
        convs.append((c_in, c_out, (3, 3, 3), (t, h, w)))
        norm(c_out)
        convs.append((c_out, c_out, (3, 3, 3), (t, h, w)))
        if c_in != c_out:
            convs.append((c_in, c_out, (1, 1, 1), (t, h, w)))

    for _ in range(2):
        resnet(chans[0], chans[0])
    c_prev = chans[0]
    for i, c in enumerate(chans):
        for j in range(cfg["layers_per_block"] + 1):
            resnet(c_prev if j == 0 else c, c)
        c_prev = c
        if i < len(chans) - 1:
            if i < in_time and t > 1:
                t = 2 * t - (t % 2)
            h, w = 2 * h, 2 * w
            convs.append((c, c, (1, 3, 3), (t, h, w)))
    norm(chans[-1])
    convs.append((chans[-1], cfg["out_channels"], (3, 3, 3), (t, h, w)))
    return convs


def conv_flops(conv: Conv) -> float:
    c_in, c_out, k, out = conv
    return 2.0 * c_in * c_out * math.prod(k) * math.prod(out)


def decoder_conv_bound_s(convs: List[Conv], elem: int = 4,
                         peak: float = roofline.PEAK_F32) -> float:
    """Sum of each conv's bound: its operations at `peak` (float32 outside
    the tensor cores: the program decodes in float32 with TF32 off), or its
    input, weight and output bytes at the HBM rate."""
    return sum(roofline.bound_s(conv_flops(cv), elem * (
        cv[0] * math.prod(cv[3]) + cv[0] * cv[1] * math.prod(cv[2]) + cv[1] * math.prod(cv[3])),
        peak) for cv in convs)
