"""The Flux VAE (16 latent channels) in plain float32, NCHW.

Follows black-forest-labs/flux `modules/autoencoder.py`: resnet blocks with
GroupNorm(32, eps 1e-6) and swish, one single-head attention block at the
bottleneck, stride-2 downsampling after a (0, 1, 0, 1) pad, nearest 2x
upsampling, latents scaled by `scale_factor` after shifting by
`shift_factor`. Conv weights are OIHW.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.common import operands


def _conv(x, p, stride: int = 1, padding: int = 1):
    x, w = operands(x, p["w"].float())
    return F.conv2d(x, w, p["b"].float(), stride=stride, padding=padding)


def _gn(x, p, groups: int = 32, eps: float = 1e-6):
    return F.group_norm(x, math.gcd(groups, x.shape[1]), p["scale"].float(), p["bias"].float(),
                        eps)


def _swish(x):
    return x * torch.sigmoid(x)


def _resnet(x, p):
    h = _conv(_swish(_gn(x, p["norm1"])), p["conv1"])
    h = _conv(_swish(_gn(h, p["norm2"])), p["conv2"])
    if "nin_shortcut" in p:
        x = _conv(x, p["nin_shortcut"], padding=0)
    return x + h


def _attn(x, p):
    b, c, h, w = x.shape
    hn = _gn(x, p["norm"])
    q, k, v = (_conv(hn, p[n], padding=0).reshape(b, c, h * w).transpose(1, 2)
               for n in "qkv")
    out = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(c), dim=-1) @ v
    return x + _conv(out.transpose(1, 2).reshape(b, c, h, w), p["proj_out"], padding=0)


def encode_moments(p: Dict, cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] pixels in [-1, 1] -> [B, 2 z, H/8, W/8] moments."""
    levels = len(cfg["ch_mult"])
    h = _conv(x, p["conv_in"])
    for i in range(levels):
        for blk in p["down"][i]["block"]:
            h = _resnet(h, blk)
        if i != levels - 1:
            h = _conv(F.pad(h, (0, 1, 0, 1)), p["down"][i]["downsample"]["conv"], stride=2,
                      padding=0)
    h = _resnet(h, p["mid_block_1"])
    h = _attn(h, p["mid_attn_1"])
    h = _resnet(h, p["mid_block_2"])
    return _conv(_swish(_gn(h, p["norm_out"])), p["conv_out"])


def encode(p: Dict, cfg: Dict, x: torch.Tensor,
           eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixels -> scaled latents: the posterior mean, or mean + std * eps."""
    mean, logvar = encode_moments(p["encoder"], cfg, x).chunk(2, dim=1)
    z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
    return cfg["scale_factor"] * (z - cfg["shift_factor"])


def decode(p: Dict, cfg: Dict, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, z, h, w] -> pixels [B, 3, 8h, 8w] (unclamped)."""
    p = p["decoder"]
    h = _conv(z / cfg["scale_factor"] + cfg["shift_factor"], p["conv_in"])
    h = _resnet(h, p["mid_block_1"])
    h = _attn(h, p["mid_attn_1"])
    h = _resnet(h, p["mid_block_2"])
    for i in reversed(range(len(cfg["ch_mult"]))):
        for blk in p["up"][i]["block"]:
            h = _resnet(h, blk)
        if i != 0:
            h = _conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                      p["up"][i]["upsample"]["conv"])
    return _conv(_swish(_gn(h, p["norm_out"])), p["conv_out"])


def to_pixels(x: torch.Tensor) -> torch.Tensor:
    """[1, 3, H, W] decoder output -> [H, W, 3] pixel values 0..255: clamped
    to [-1, 1], scaled, truncated to integers as a uint8 image is."""
    return torch.floor((torch.clamp(x[0], -1.0, 1.0) + 1.0) * 127.5).permute(1, 2, 0)

