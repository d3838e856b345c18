"""CogVideoX 3D causal VAE (the diffusers `AutoencoderKLCogVideoX` layout).

Counterpart of the JAX package's `models/video/vae.py`, in f32: causal 3D
convolutions (time front-padded with the first frame repeated, so no frame
sees the future), GroupNorm/silu resnets, the decoder's latent-conditioned
SpatialNorm3D, and first-frame-special temporal pooling and upsampling.
Activations are NCDHW and kernels OIDHW, as in JAX, so a numpy parameter
tree from it converts leaf by leaf. The JAX package convolves outside any
Pallas kernel; here the convolutions are `F.conv3d` / `F.conv2d`.

  encoder: conv_in -> down blocks (resnets; a downsampler after all but the
           last; temporal compression on the first log2(ratio) blocks)
           -> mid (2 resnets) -> GroupNorm -> silu -> conv_out
  decoder: conv_in -> mid (2 resnets, SpatialNorm3D) -> up blocks (one more
           resnet each; an upsampler after all but the last; temporal 2x on
           the first log2(ratio) blocks) -> SpatialNorm3D -> silu -> conv_out
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.models.flux.params import Params

# Output frames computed at a time by the frame-wise steps (causal convs,
# upsamplers, SpatialNorm3D's modulation). The decoder's full-size
# activations (49 frames at 480x720 and 256 channels: 17 GB in f32) are then
# made once each and never padded, transposed or upsampled whole; every
# output frame is the same function of the same input frames.
FRAME_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    layers_per_block: int = 3
    temporal_compression_ratio: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 1.15258426

    @property
    def temporal_compress_level(self) -> int:
        return int(math.log2(self.temporal_compression_ratio))


def _frame_pieces(t: int, size: int):
    return [(t0, min(t, t0 + size)) for t0 in range(0, t, size)]


def causal_conv3d(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Temporal front pad with the first frame repeated (kernel_t - 1)
    times, zero 'same' padding in space, stride 1; FRAME_CHUNK output
    frames at a time."""
    kt, kh, kw = p["w"].shape[2:]
    t = x.shape[2]
    out = None
    for t0, t1 in _frame_pieces(t, FRAME_CHUNK):
        lo = t0 - (kt - 1)
        src = x[:, :, max(lo, 0):t1]
        if lo < 0:
            src = torch.cat([x[:, :, :1].expand(-1, -1, -lo, -1, -1), src], dim=2)
        y = F.conv3d(src, p["w"], p["b"], padding=(0, kh // 2, kw // 2))
        if t1 - t0 == t:
            return y
        if out is None:
            out = y.new_empty((*y.shape[:2], t, *y.shape[3:]))
        out[:, :, t0:t1] = y
    return out


def plain_conv3d_1x1(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Kernel-1 Conv3d (resnet shortcut, SpatialNorm3D convs): a pointwise mix."""
    return F.conv3d(x, p["w"], p["b"])


def _conv2d_per_frame(x: torch.Tensor, p: Params, stride: int = 1,
                      padding=((1, 1), (1, 1))) -> torch.Tensor:
    """A Conv2d [O, I, kh, kw] on every frame of [B, C, T, H, W], with
    (top, bottom), (left, right) zero padding."""
    b, c, t, h, w = x.shape
    xf = x.transpose(1, 2).reshape(b * t, c, h, w)
    (top, bottom), (left, right) = padding
    xf = F.pad(xf, (left, right, top, bottom))
    y = F.conv2d(xf, p["w"], p["b"], stride=stride)
    _, co, ho, wo = y.shape
    return y.reshape(b, t, co, ho, wo).transpose(1, 2)


def group_norm3d(x: torch.Tensor, p: Params, num_groups: int = 32,
                 eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over (C/g, T, H, W); the group count falls to gcd(g, C)
    for tiny test widths."""
    c = x.shape[1]
    if c % num_groups:
        num_groups = math.gcd(num_groups, c)
    return F.group_norm(x, num_groups, p["scale"], p["bias"], eps)


def spatial_norm3d(f: torch.Tensor, zq: torch.Tensor, p: Params,
                   num_groups: int = 32) -> torch.Tensor:
    """CogVideoXSpatialNorm3D: GroupNorm(f) modulated by 1x1 convs of the
    latent zq, nearest-resized to f's grid (the first frame apart when T is
    odd, so the temporal ratio stays exact)."""
    if f.shape[2] > 1 and f.shape[2] % 2 == 1:
        zf = F.interpolate(zq[:, :, :1], size=(1, *f.shape[3:]), mode="nearest")
        zr = F.interpolate(zq[:, :, 1:], size=(f.shape[2] - 1, *f.shape[3:]), mode="nearest")
        zq = torch.cat([zf, zr], dim=2)
    else:
        zq = F.interpolate(zq, size=tuple(f.shape[2:]), mode="nearest")
    normed = group_norm3d(f, p["norm"], num_groups)
    for t0, t1 in _frame_pieces(f.shape[2], FRAME_CHUNK):
        z = zq[:, :, t0:t1]
        normed[:, :, t0:t1] = (normed[:, :, t0:t1] * plain_conv3d_1x1(z, p["conv_y"])
                               + plain_conv3d_1x1(z, p["conv_b"]))
    return normed


def _resnet3d(x: torch.Tensor, p: Params, zq: Optional[torch.Tensor] = None,
              num_groups: int = 32) -> torch.Tensor:
    """CogVideoXResnetBlock3D (eval mode, no temb)."""
    def norm(h, np_):
        return group_norm3d(h, np_, num_groups) if zq is None else spatial_norm3d(h, zq, np_, num_groups)

    h = causal_conv3d(F.silu(norm(x, p["norm1"]), inplace=True), p["conv1"])
    h = causal_conv3d(F.silu(norm(h, p["norm2"]), inplace=True), p["conv2"])
    if "conv_shortcut" in p:
        x = plain_conv3d_1x1(x, p["conv_shortcut"])
    return h.add_(x)


def _downsample3d(x: torch.Tensor, p: Params, compress_time: bool) -> torch.Tensor:
    """Optional first-frame-special temporal average pool, then a
    right/bottom-padded stride-2 Conv2d per frame."""
    if compress_time:
        b, c, t, h, w = x.shape
        if t % 2 == 1 and t > 1:
            rest = x[:, :, 1:].reshape(b, c, (t - 1) // 2, 2, h, w).mean(dim=3)
            x = torch.cat([x[:, :, :1], rest], dim=2)
        else:
            x = x.reshape(b, c, t // 2, 2, h, w).mean(dim=3)
    return _conv2d_per_frame(x, p, stride=2, padding=((0, 1), (0, 1)))


def _up2(x: torch.Tensor, dims) -> torch.Tensor:
    for d in dims:
        x = x.repeat_interleave(2, dim=d)
    return x


def _upsample3d(x: torch.Tensor, p: Params, compress_time: bool) -> torch.Tensor:
    """Nearest 2x in space, and in time on all but a leading odd first
    frame, then a 3x3 Conv2d per frame; FRAME_CHUNK / 2 input frames at a
    time."""
    t = x.shape[2]
    first_alone = compress_time and t > 1 and t % 2 == 1
    in_time = compress_time and t > 1
    t_out = 2 * t - first_alone if in_time else t
    out = None
    for i0, i1 in _frame_pieces(t, max(1, FRAME_CHUNK // 2)):
        if first_alone:
            parts = [_up2(x[:, :, :1], (3, 4))] if i0 == 0 else []
            parts.append(_up2(x[:, :, max(i0, 1):i1], (2, 3, 4)))
            up, o0, o1 = torch.cat(parts, dim=2), max(2 * i0 - 1, 0), 2 * i1 - 1
        elif in_time:
            up, o0, o1 = _up2(x[:, :, i0:i1], (2, 3, 4)), 2 * i0, 2 * i1
        else:
            up, o0, o1 = _up2(x[:, :, i0:i1], (3, 4)), i0, i1
        y = _conv2d_per_frame(up, p, stride=1, padding=((1, 1), (1, 1)))
        if o1 - o0 == t_out:
            return y
        if out is None:
            out = y.new_empty((*y.shape[:2], t_out, *y.shape[3:]))
        out[:, :, o0:o1] = y
    return out


def encoder_apply(p: Params, cfg: CogVideoXVAEConfig, x: torch.Tensor) -> torch.Tensor:
    g = cfg.norm_num_groups
    h = causal_conv3d(x, p["conv_in"])
    for i, block in enumerate(p["down"]):
        for r in block["resnets"]:
            h = _resnet3d(h, r, num_groups=g)
        if "downsample" in block:
            h = _downsample3d(h, block["downsample"], compress_time=i < cfg.temporal_compress_level)
    for r in p["mid"]:
        h = _resnet3d(h, r, num_groups=g)
    h = F.silu(group_norm3d(h, p["norm_out"], g))
    return causal_conv3d(h, p["conv_out"])  # [B, 2 * latent, T', H/8, W/8]


def decoder_apply(p: Params, cfg: CogVideoXVAEConfig, z: torch.Tensor) -> torch.Tensor:
    g = cfg.norm_num_groups
    h = causal_conv3d(z, p["conv_in"])
    for r in p["mid"]:
        h = _resnet3d(h, r, zq=z, num_groups=g)
    for i, block in enumerate(p["up"]):
        for r in block["resnets"]:
            h = _resnet3d(h, r, zq=z, num_groups=g)
        if "upsample" in block:
            h = _upsample3d(h, block["upsample"], compress_time=i < cfg.temporal_compress_level)
    h = F.silu(spatial_norm3d(h, z, p["norm_out"], g), inplace=True)
    return causal_conv3d(h, p["conv_out"])


def encode(p: Params, cfg: CogVideoXVAEConfig, x: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, 3, F, H, W] pixels -> scaled latents: the posterior mean, or a
    draw from `generator`. F = 1 + 4k frames give 1 + k latent frames."""
    mean, logvar = encoder_apply(p["encoder"], cfg, x).chunk(2, dim=1)
    if generator is not None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise
    return mean * cfg.scaling_factor


def decode(p: Params, cfg: CogVideoXVAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, C, F, h, w] -> [B, 3, F', H, W] pixels."""
    return decoder_apply(p["decoder"], cfg, z / cfg.scaling_factor)


def init_video_vae_params(
    generator: torch.Generator,
    cfg: CogVideoXVAEConfig = CogVideoXVAEConfig(),
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random init on the generator's device with the JAX package's
    distributions (kernels N(0, 1/fan_in), zero biases, unit norm scales)."""
    dev = generator.device

    def conv(cin, cout, k):
        fan = cin * math.prod(k)
        w = torch.randn((cout, cin, *k), generator=generator, device=dev) / fan**0.5
        return {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype, device=dev)}

    def gn(c):
        return {"scale": torch.ones(c, dtype=dtype, device=dev),
                "bias": torch.zeros(c, dtype=dtype, device=dev)}

    def sn(c, zc):
        return {"norm": gn(c), "conv_y": conv(zc, c, (1, 1, 1)), "conv_b": conv(zc, c, (1, 1, 1))}

    def resnet(cin, cout, spatial: bool):
        zc = cfg.latent_channels
        p: Dict[str, Any] = {
            "norm1": sn(cin, zc) if spatial else gn(cin),
            "conv1": conv(cin, cout, (3, 3, 3)),
            "norm2": sn(cout, zc) if spatial else gn(cout),
            "conv2": conv(cout, cout, (3, 3, 3)),
        }
        if cin != cout:
            p["conv_shortcut"] = conv(cin, cout, (1, 1, 1))
        return p

    boc = cfg.block_out_channels
    down, c_prev = [], boc[0]
    for i, c_out in enumerate(boc):
        block: Dict[str, Any] = {"resnets": [
            resnet(c_prev if j == 0 else c_out, c_out, False) for j in range(cfg.layers_per_block)
        ]}
        if i < len(boc) - 1:
            block["downsample"] = conv(c_out, c_out, (3, 3))
        down.append(block)
        c_prev = c_out
    enc = {
        "conv_in": conv(cfg.in_channels, boc[0], (3, 3, 3)),
        "down": down,
        "mid": [resnet(boc[-1], boc[-1], False) for _ in range(2)],
        "norm_out": gn(boc[-1]),
        "conv_out": conv(boc[-1], 2 * cfg.latent_channels, (3, 3, 3)),
    }

    rboc = boc[::-1]
    up, c_prev = [], rboc[0]
    for i, c_out in enumerate(rboc):
        block = {"resnets": [
            resnet(c_prev if j == 0 else c_out, c_out, True) for j in range(cfg.layers_per_block + 1)
        ]}
        if i < len(rboc) - 1:
            block["upsample"] = conv(c_out, c_out, (3, 3))
        up.append(block)
        c_prev = c_out
    dec = {
        "conv_in": conv(cfg.latent_channels, rboc[0], (3, 3, 3)),
        "mid": [resnet(rboc[0], rboc[0], True) for _ in range(2)],
        "up": up,
        "norm_out": sn(rboc[-1], cfg.latent_channels),
        "conv_out": conv(rboc[-1], cfg.out_channels, (3, 3, 3)),
    }
    return {"encoder": enc, "decoder": dec}
