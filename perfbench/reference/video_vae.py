"""The CogVideoX 3D causal VAE's decoder in plain float32, NCDHW.

Follows diffusers' `AutoencoderKLCogVideoX` decoder (`CogVideoXDecoder3D`):
conv_in, a mid block of 2 resnets, 4 up blocks of layers_per_block + 1
resnets each with an upsampler after all but the last (2x in time on the
first log2(temporal_compression_ratio) blocks, a leading odd first frame
kept alone), SpatialNorm3D, SiLU and conv_out. Resnets: SpatialNorm3D
(GroupNorm(32, eps 1e-6) times a 1x1x1 conv of the latent, plus another,
the latent nearest-resized to the features, its first frame alone when the
frame count is odd), SiLU, causal conv, again, and a 1x1x1 shortcut where
the width changes. A causal conv pads time in front with the first frame
repeated (kernel_t - 1 times) and space with zeros. Latents are divided by
`scaling_factor` first.

One departure: the whole clip is decoded at once, as the JAX package and
the program do. diffusers decodes two latent frames at a time with a cache
of each causal conv's last frames, so its GroupNorm statistics are taken
per batch of frames. The convolutions run over chunks of output frames to
fit the card (each output frame is the same function of the same input
frames); nothing else is chunked.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.common import operands

CHUNK = 4  # output frames a convolution computes at a time


def _conv(x, p, padding):
    """One convolution of x (4D or 5D) with the scope's rounding (`common.rounded`)."""
    x, w = operands(x, p["w"].float())
    conv = F.conv3d if w.dim() == 5 else F.conv2d
    return conv(x, w, p["b"].float(), padding=padding)


def causal_conv(x: torch.Tensor, p: Dict) -> torch.Tensor:
    kt, kh, kw = p["w"].shape[2:]
    t = x.shape[2]
    out = None
    for t0 in range(0, t, CHUNK):
        t1 = min(t, t0 + CHUNK)
        idx = torch.arange(t0 - (kt - 1), t1, device=x.device).clamp_min(0)  # first frame repeated
        y = _conv(x[:, :, idx], p, (0, kh // 2, kw // 2))
        if out is None:
            out = y.new_empty((*y.shape[:2], t, *y.shape[3:]))
        out[:, :, t0:t1] = y
    return out


def _gn(x, p, groups: int):
    c = x.shape[1]
    return F.group_norm(x, math.gcd(groups, c), p["scale"].float(), p["bias"].float(), 1e-6)


def _resize(z: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    if t > 1 and t % 2 == 1:
        return torch.cat([F.interpolate(z[:, :, :1], size=(1, h, w)),
                          F.interpolate(z[:, :, 1:], size=(t - 1, h, w))], dim=2)
    return F.interpolate(z, size=(t, h, w))


def spatial_norm(f: torch.Tensor, z: torch.Tensor, p: Dict, groups: int) -> torch.Tensor:
    zq = _resize(z, *f.shape[2:])
    out = _gn(f, p["norm"], groups)
    for t0 in range(0, f.shape[2], CHUNK):
        zc = zq[:, :, t0:t0 + CHUNK]
        out[:, :, t0:t0 + CHUNK] = (out[:, :, t0:t0 + CHUNK] * _conv(zc, p["conv_y"], 0)
                                    + _conv(zc, p["conv_b"], 0))
    return out


def pointwise(x: torch.Tensor, p: Dict) -> torch.Tensor:
    out = None
    for t0 in range(0, x.shape[2], CHUNK):
        y = _conv(x[:, :, t0:t0 + CHUNK], p, 0)
        if out is None:
            out = y.new_empty((*y.shape[:2], x.shape[2], *y.shape[3:]))
        out[:, :, t0:t0 + CHUNK] = y
    return out


def resnet(x: torch.Tensor, p: Dict, z: torch.Tensor, groups: int) -> torch.Tensor:
    h = causal_conv(F.silu(spatial_norm(x, z, p["norm1"], groups), inplace=True), p["conv1"])
    h = causal_conv(F.silu(spatial_norm(h, z, p["norm2"], groups), inplace=True), p["conv2"])
    if "conv_shortcut" in p:
        x = pointwise(x, p["conv_shortcut"])
    return h.add_(x)


def upsample(x: torch.Tensor, p: Dict, in_time: bool) -> torch.Tensor:
    """`CogVideoXUpsample3D`: nearest 2x (in time too where `in_time`, a
    leading odd first frame kept alone), then the 3x3 Conv2d on each frame."""
    b, c, t, h, w = x.shape
    if in_time and t > 1:
        src = ([0] if t % 2 == 1 else []) + [i for i in range(t % 2, t) for _ in (0, 1)]
    else:
        src = list(range(t))
    out = None
    for o0 in range(0, len(src), CHUNK):
        frames = x[:, :, src[o0:o0 + CHUNK]].transpose(1, 2).reshape(-1, c, h, w)
        y = _conv(F.interpolate(frames, scale_factor=2.0), p, 1)
        y = y.reshape(b, -1, *y.shape[1:]).transpose(1, 2)
        if out is None:
            out = y.new_empty((b, y.shape[1], len(src), *y.shape[3:]))
        out[:, :, o0:o0 + CHUNK] = y
    return out


def decode(params: Dict, cfg: Dict, latents: torch.Tensor) -> torch.Tensor:
    """Latents [1, F, C, h, w] (the DiT's layout) -> pixels [1, 3, F', 8h, 8w]
    (unclamped). `cfg`: scaling_factor, temporal_compression_ratio,
    norm_num_groups."""
    p = params["decoder"]
    g = cfg["norm_num_groups"]
    z = latents.float().transpose(1, 2) / cfg["scaling_factor"]
    h = causal_conv(z, p["conv_in"])
    for r in p["mid"]:
        h = resnet(h, r, z, g)
    in_time = int(math.log2(cfg["temporal_compression_ratio"]))
    for i, block in enumerate(p["up"]):
        for r in block["resnets"]:
            h = resnet(h, r, z, g)
        if "upsample" in block:
            h = upsample(h, block["upsample"], i < in_time)
    return causal_conv(F.silu(spatial_norm(h, z, p["norm_out"], g), inplace=True), p["conv_out"])


def to_frames(x: torch.Tensor) -> torch.Tensor:
    """[1, 3, F, H, W] decoder output -> [F, H, W, 3] pixel values 0..255:
    clamped to [-1, 1], scaled, truncated as a uint8 frame is."""
    return torch.floor((torch.clamp(x[0], -1.0, 1.0) + 1.0) * 127.5).permute(1, 2, 3, 0)
