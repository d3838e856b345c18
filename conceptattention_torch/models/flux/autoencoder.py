"""Flux VAE (encoder / decoder CNN) as plain functions on tensors.

Counterpart of the JAX package's `models/flux/autoencoder.py`: resnet CNN
with a single-head attention block at the bottleneck, GroupNorm(32, eps 1e-6),
swish, asymmetric-padded stride-2 downsampling, nearest upsampling, scale
0.3611 / shift 0.1159. Conv weights stay OIHW so trees from the JAX package
convert leaf by leaf.

Each half has an NCHW form on `F.conv2d` (`encode`, `decode`) and an NHWC
form (`encode_nhwc`, `decode_nhwc`) that keeps NHWC activations inside and,
on a card, routes each gated 3x3 conv through the conv3x3 kernel and, in
bf16, the mid-attention through the flash-saliency kernel; other convs
(the 3-channel input conv, the stride-2 downsamples, the 1x1 convs) stay on
`F.conv2d`. The pipeline encodes NCHW and decodes NHWC.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from conceptattention_torch.config import AutoEncoderConfig
from conceptattention_torch.kernels.conv3x3 import conv3x3_same, use_conv3x3_kernel
from conceptattention_torch.kernels.flash_saliency import fused_concept_flash_attention

Params = Dict[str, Any]


def conv2d(x, p, stride: int = 1, padding: int = 1):
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def _groups(c: int, num_groups: int) -> int:
    return num_groups if c % num_groups == 0 else math.gcd(num_groups, c)


def group_norm(x, p, num_groups: int = 32, eps: float = 1e-6):
    b, c, h, w = x.shape
    g = _groups(c, num_groups)
    xf = x.float().reshape(b, g, c // g, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w).to(x.dtype)
    return xf * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def swish(x):
    return x * torch.sigmoid(x)


def _attention_plain(q, k, v):
    """Single-head attention over [B, S, C]: f32 logits and softmax, weights
    cast to v's dtype."""
    logits = (q.float() @ k.float().transpose(1, 2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


def attn_block(x, p):
    """Single-head self-attention over the h*w grid (NCHW)."""
    b, c, h, w = x.shape
    h_ = group_norm(x, p["norm"])
    q, k, v = (conv2d(h_, p[n], padding=0).reshape(b, c, h * w).transpose(1, 2) for n in "qkv")
    out = _attention_plain(q, k, v).transpose(1, 2).reshape(b, c, h, w)
    return x + conv2d(out, p["proj_out"], padding=0)


def resnet_block(x, p):
    h = conv2d(swish(group_norm(x, p["norm1"])), p["conv1"])
    h = conv2d(swish(group_norm(h, p["norm2"])), p["conv2"])
    if "nin_shortcut" in p:
        x = conv2d(x, p["nin_shortcut"], padding=0)
    return x + h


def downsample(x, p):
    # Asymmetric (0, 1), (0, 1) pad, then a stride-2 3x3 conv.
    return conv2d(F.pad(x, (0, 1, 0, 1)), p["conv"], stride=2, padding=0)


def encoder_apply(p: Params, cfg: AutoEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] pixels in [-1, 1] -> [B, 2*z, H/f, W/f] moments (NCHW)."""
    h = conv2d(x, p["conv_in"])
    for i_level in range(len(cfg.ch_mult)):
        for i_block in range(cfg.num_res_blocks):
            h = resnet_block(h, p["down"][i_level]["block"][i_block])
        if i_level != len(cfg.ch_mult) - 1:
            h = downsample(h, p["down"][i_level]["downsample"])
    h = resnet_block(h, p["mid_block_1"])
    h = attn_block(h, p["mid_attn_1"])
    h = resnet_block(h, p["mid_block_2"])
    h = swish(group_norm(h, p["norm_out"]))
    return conv2d(h, p["conv_out"])


def upsample(x, p):
    return conv2d(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3), p["conv"])


def decoder_apply(p: Params, cfg: AutoEncoderConfig, z: torch.Tensor) -> torch.Tensor:
    """[B, z, h, w] latents -> [B, 3, H, W] pixels (NCHW)."""
    h = conv2d(z, p["conv_in"])
    h = resnet_block(h, p["mid_block_1"])
    h = attn_block(h, p["mid_attn_1"])
    h = resnet_block(h, p["mid_block_2"])
    for i_level in reversed(range(len(cfg.ch_mult))):
        for i_block in range(cfg.num_res_blocks + 1):
            h = resnet_block(h, p["up"][i_level]["block"][i_block])
        if i_level != 0:
            h = upsample(h, p["up"][i_level]["upsample"])
    h = swish(group_norm(h, p["norm_out"]))
    return conv2d(h, p["conv_out"])


def encode(p: Params, cfg: AutoEncoderConfig, x: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pixels -> scaled latents through the NCHW encoder: the posterior mean,
    or a reparameterized draw from `generator`."""
    return vae_latents(encoder_apply(p["encoder"], cfg, x), cfg, generator)


def decode(p: Params, cfg: AutoEncoderConfig, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, z, h, w] -> pixels [B, 3, H, W] through the NCHW decoder."""
    return decoder_apply(p["decoder"], cfg, z / cfg.scale_factor + cfg.shift_factor)


# ----------------------------------------------------------------------------
# NHWC encoder and decoder: activations [B, H, W, C], weights still OIHW.
# ----------------------------------------------------------------------------


def _conv2d_nhwc(x, p, stride: int = 1, padding: int = 1):
    w = p["w"]
    if (
        stride == 1 and padding == 1 and w.shape[2:] == (3, 3)
        and use_conv3x3_kernel(x, x.shape[-1], w.shape[0])
    ):
        return conv3x3_same(x.contiguous(), w.permute(2, 3, 1, 0).contiguous(), p["b"])
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["b"], stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _group_norm_nhwc(x, p, num_groups: int = 32, eps: float = 1e-6):
    b, h, w, c = x.shape
    g = _groups(c, num_groups)
    xf = x.float().reshape(b, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(x.dtype)
    return xf * p["scale"] + p["bias"]


def _attn_block_nhwc(x, p):
    b, h, w, c = x.shape
    h_ = _group_norm_nhwc(x, p["norm"])
    q, k, v = (_conv2d_nhwc(h_, p[n], padding=0).reshape(b, h * w, c) for n in "qkv")
    s = h * w
    if x.is_cuda and x.dtype == torch.bfloat16:
        # Every bf16 decode on the card: the flash kernel streams this
        # one-head attention (16k tokens at 1024^2) and masks ragged tails,
        # instead of materializing S x S logits.
        out = fused_concept_flash_attention(
            q[:, None].contiguous(), k[:, None].contiguous(), v[:, None].contiguous(),
            txt_len=s, img_len=0, concept_len=0,
        )[:, 0]
    else:
        out = _attention_plain(q, k, v)
    return x + _conv2d_nhwc(out.reshape(b, h, w, c), p["proj_out"], padding=0)


def _resnet_block_nhwc(x, p):
    h = _conv2d_nhwc(swish(_group_norm_nhwc(x, p["norm1"])), p["conv1"])
    h = _conv2d_nhwc(swish(_group_norm_nhwc(h, p["norm2"])), p["conv2"])
    if "nin_shortcut" in p:
        x = _conv2d_nhwc(x, p["nin_shortcut"], padding=0)
    return x + h


def _upsample_nhwc(x, p):
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return _conv2d_nhwc(x, p["conv"])


def _downsample_nhwc(x, p):
    return _conv2d_nhwc(F.pad(x, (0, 0, 0, 1, 0, 1)), p["conv"], stride=2, padding=0)


def encoder_apply_nhwc(p: Params, cfg: AutoEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """NCHW pixels -> NCHW moments, NHWC inside."""
    h = _conv2d_nhwc(x.permute(0, 2, 3, 1), p["conv_in"])
    for i_level in range(len(cfg.ch_mult)):
        for i_block in range(cfg.num_res_blocks):
            h = _resnet_block_nhwc(h, p["down"][i_level]["block"][i_block])
        if i_level != len(cfg.ch_mult) - 1:
            h = _downsample_nhwc(h, p["down"][i_level]["downsample"])
    h = _resnet_block_nhwc(h, p["mid_block_1"])
    h = _attn_block_nhwc(h, p["mid_attn_1"])
    h = _resnet_block_nhwc(h, p["mid_block_2"])
    h = swish(_group_norm_nhwc(h, p["norm_out"]))
    h = _conv2d_nhwc(h, p["conv_out"])
    return h.permute(0, 3, 1, 2)


def encode_nhwc(p: Params, cfg: AutoEncoderConfig, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`encode` through the NHWC encoder (same math, same NCHW interface)."""
    return vae_latents(encoder_apply_nhwc(p["encoder"], cfg, x), cfg, generator)


def decoder_apply_nhwc(p: Params, cfg: AutoEncoderConfig, z: torch.Tensor) -> torch.Tensor:
    """NCHW latents -> NCHW pixels, NHWC inside."""
    h = _conv2d_nhwc(z.permute(0, 2, 3, 1), p["conv_in"])
    h = _resnet_block_nhwc(h, p["mid_block_1"])
    h = _attn_block_nhwc(h, p["mid_attn_1"])
    h = _resnet_block_nhwc(h, p["mid_block_2"])
    for i_level in reversed(range(len(cfg.ch_mult))):
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resnet_block_nhwc(h, p["up"][i_level]["block"][i_block])
        if i_level != 0:
            h = _upsample_nhwc(h, p["up"][i_level]["upsample"])
    h = swish(_group_norm_nhwc(h, p["norm_out"]))
    h = _conv2d_nhwc(h, p["conv_out"])
    return h.permute(0, 3, 1, 2)


def decode_nhwc(p: Params, cfg: AutoEncoderConfig, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, z, h, w] -> pixels [B, 3, H, W] through the NHWC decoder."""
    z = z / cfg.scale_factor + cfg.shift_factor
    return decoder_apply_nhwc(p["decoder"], cfg, z)


# ----------------------------------------------------------------------------
# Random init, with the JAX package's distributions.
# ----------------------------------------------------------------------------


def init_autoencoder_params(
    generator: torch.Generator, cfg: AutoEncoderConfig, dtype: torch.dtype = torch.float32
) -> Params:
    """Random VAE parameters on the generator's device: conv weights
    N(0, 1/fan_in) in OIHW, zero biases, unit GroupNorm scales."""
    device = generator.device

    def conv(c_in, c_out, k):
        w = torch.randn((c_out, c_in, k, k), generator=generator, device=device) / math.sqrt(c_in * k * k)
        return {"w": w.to(dtype), "b": torch.zeros((c_out,), dtype=dtype, device=device)}

    def gn(c):
        return {"scale": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    def resnet(c_in, c_out):
        p = {"norm1": gn(c_in), "conv1": conv(c_in, c_out, 3),
             "norm2": gn(c_out), "conv2": conv(c_out, c_out, 3)}
        if c_in != c_out:
            p["nin_shortcut"] = conv(c_in, c_out, 1)
        return p

    def attn(c):
        return {"norm": gn(c), "q": conv(c, c, 1), "k": conv(c, c, 1),
                "v": conv(c, c, 1), "proj_out": conv(c, c, 1)}

    n_levels = len(cfg.ch_mult)
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    enc: Params = {"conv_in": conv(cfg.in_channels, cfg.ch, 3)}
    down = []
    block_in = cfg.ch
    for i_level in range(n_levels):
        block_in = cfg.ch * in_ch_mult[i_level]
        block_out = cfg.ch * cfg.ch_mult[i_level]
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(resnet(block_in, block_out))
            block_in = block_out
        level: Params = {"block": blocks}
        if i_level != n_levels - 1:
            level["downsample"] = {"conv": conv(block_in, block_in, 3)}
        down.append(level)
    enc["down"] = down
    enc["mid_block_1"] = resnet(block_in, block_in)
    enc["mid_attn_1"] = attn(block_in)
    enc["mid_block_2"] = resnet(block_in, block_in)
    enc["norm_out"] = gn(block_in)
    enc["conv_out"] = conv(block_in, 2 * cfg.z_channels, 3)

    block_in = cfg.ch * cfg.ch_mult[-1]
    dec: Params = {"conv_in": conv(cfg.z_channels, block_in, 3)}
    dec["mid_block_1"] = resnet(block_in, block_in)
    dec["mid_attn_1"] = attn(block_in)
    dec["mid_block_2"] = resnet(block_in, block_in)
    up: list = [None] * n_levels
    for i_level in reversed(range(n_levels)):
        block_out = cfg.ch * cfg.ch_mult[i_level]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(resnet(block_in, block_out))
            block_in = block_out
        level = {"block": blocks}
        if i_level != 0:
            level["upsample"] = {"conv": conv(block_in, block_in, 3)}
        up[i_level] = level
    dec["up"] = up
    dec["norm_out"] = gn(block_in)
    dec["conv_out"] = conv(block_in, cfg.out_ch, 3)
    return {"encoder": enc, "decoder": dec}


def vae_latents(moments: torch.Tensor, cfg: AutoEncoderConfig,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encoder moments -> scaled latents: the posterior mean, or a
    reparameterized draw from `generator`."""
    mean, logvar = moments.chunk(2, dim=1)
    z = mean
    if generator is not None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        z = mean + torch.exp(0.5 * logvar) * eps
    return cfg.scale_factor * (z - cfg.shift_factor)
