"""The Stable Diffusion 2 / SDXL UNet with its cross-attention probabilities
returned: the backbone of the DAAM-SD baselines.

Counterpart of the JAX package's `models/sd_unet.py`, the subset of
diffusers' `UNet2DConditionModel` that the `stable-diffusion-2-base` and
`stable-diffusion-xl-base-1.0` checkpoints use, so either loads through
`weights/convert.convert_sd_unet_state_dict`:
  - down blocks of `layers_per_block` resnets, each followed at a
    cross-attention level by a transformer; one skip saved after every
    resnet and after every downsampler; the up blocks pop one skip per
    resnet (`layers_per_block + 1` a level) and end in a nearest 2x
    upsample and a conv at every level but the last;
  - a transformer (`use_linear_projection=True`): GroupNorm (eps 1e-6),
    linear proj_in, `transformer_layers_per_block[level]` blocks of
    LayerNorm -> self-attention -> LayerNorm -> cross-attention ->
    LayerNorm -> GEGLU feed-forward, linear proj_out, residual. SD2 has one
    block everywhere; SDXL (1, 2, 10) per level, the mid block the deepest;
  - attention with bias-free q / k / v and a biased output projection;
  - resnets: GroupNorm (eps 1e-5) -> SiLU -> 3x3 conv, the time embedding's
    projection added after the first conv, a 1x1 shortcut on a channel
    change;
  - the sinusoidal timestep embedding (cos first) -> a 2-layer MLP; SDXL
    adds the "text_time" embedding: the pooled text and six sinusoidal
    time-id embeddings through another MLP, added onto it.

`unet_forward` returns every cross-attention's probabilities, one map per
transformer block: what DAAM's hooks collect. Everything is `F.conv2d` and
`torch.matmul`, in the parameters' dtype (f32 for the zoo; run it under
`_full_f32()` on a card so cuBLAS and cuDNN keep TF32 off). The feed-forward's
GELU is the tanh form, as `jax.nn.gelu`'s default (diffusers uses the erf form).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The SD2-base UNet by default (its unet/config.json)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # heads per level (64-dim heads in SD2: 320/5, 640/10, 1280/20)
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    # the levels that carry transformers (SD2: all but the deepest; SDXL:
    # all but the first)
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    context_dim: int = 1024  # SD2: OpenCLIP-H's width; SDXL: 2048 (two encoders)
    num_groups: int = 32
    norm_eps: float = 1e-5
    # transformer blocks per transformer, per level; None is one everywhere
    # (SD2). SDXL-base: (1, 2, 10); the mid block takes the last entry.
    transformer_layers_per_block: Optional[Tuple[int, ...]] = None
    # "text_time" (SDXL): aug = MLP(concat(pooled text, sin(time ids)))
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    # add_embedding's input width (SDXL-base: 1280 pooled + 6 x 256 = 2816)
    projection_class_embeddings_input_dim: int = 0

    def tlayers(self, level: int) -> int:
        if self.transformer_layers_per_block is None:
            return 1
        return self.transformer_layers_per_block[level]

    @property
    def pooled_text_dim(self) -> int:
        """Width of the pooled text in the text_time embedding."""
        return self.projection_class_embeddings_input_dim - 6 * self.addition_time_embed_dim


# stabilityai/stable-diffusion-xl-base-1.0 unet/config.json: 3 levels,
# transformer depths (1, 2, 10), a 2048-wide context, text_time embeddings.
SDXL_BASE_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280),
    layers_per_block=2,
    attention_heads=(5, 10, 20),
    cross_attention_levels=(False, True, True),
    context_dim=2048,
    transformer_layers_per_block=(1, 2, 10),
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)


def _conv(x, p, stride: int = 1, padding: int = 1):
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation, f64 kept."""
    return torch.promote_types(dtype, torch.float32)


def _gn(x, p, groups: int, eps: float = 1e-5):
    """GroupNorm over gcd(groups, C) groups, normalised in f32 and cast back
    to x's dtype before the affine."""
    g = math.gcd(groups, x.shape[1])
    xn = F.group_norm(x.to(_acc(x.dtype)), g, eps=eps).to(x.dtype)
    return xn * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def _ln(x, p, eps: float = 1e-5):
    """LayerNorm with the affine applied in f32, then cast to x's dtype."""
    acc = _acc(x.dtype)
    return F.layer_norm(x.to(acc), x.shape[-1:], p["scale"].to(acc), p["bias"].to(acc),
                        eps).to(x.dtype)


def _linear(x, p):
    return x @ p["w"] + p["b"]


def _timesteps_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' Timesteps(dim, flip_sin_to_cos=True, shift=0), in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _resblock(p, x, temb, groups: int, eps: float):
    h = _conv(F.silu(_gn(x, p["norm1"], groups, eps)), p["conv1"])
    h = h + _linear(F.silu(temb), p["time_emb"])[:, :, None, None]
    h = _conv(F.silu(_gn(h, p["norm2"], groups, eps)), p["conv2"])
    if "shortcut" in p:
        x = _conv(x, p["shortcut"], padding=0)
    return x + h


def _attention(p, x_seq, context, num_heads: int):
    """Bias-free q / k / v, a biased output projection. Returns (out, probs
    [B, H, N, T]); the scores and softmax run in f32."""
    b, n, c = x_seq.shape
    hd = c // num_heads
    q = (x_seq @ p["q"]["w"]).reshape(b, n, num_heads, hd).transpose(1, 2)
    k = (context @ p["k"]["w"]).reshape(b, -1, num_heads, hd).transpose(1, 2)
    v = (context @ p["v"]["w"]).reshape(b, -1, num_heads, hd).transpose(1, 2)
    acc = _acc(q.dtype)
    logits = q.to(acc) @ k.to(acc).transpose(-1, -2)
    probs = torch.softmax(logits / hd**0.5, dim=-1)
    out = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(b, n, c)
    return _linear(out, p["proj"]), probs


def _geglu_ff(p, x):
    """GEGLU: net.0.proj -> split -> value * gelu(gate) -> net.2."""
    val, gate = _linear(x, p["ff_in"]).chunk(2, dim=-1)
    return _linear(val * F.gelu(gate, approximate="tanh"), p["ff_out"])


def _transformer_block(p, x, context, num_heads: int, groups: int):
    """A transformer of len(p["blocks"]) blocks on a [B, C, H, W] map.
    Returns (x, the cross-attention probabilities of each block)."""
    b, c, h, w = x.shape
    seq = _gn(x, p["norm"], groups, eps=1e-6).reshape(b, c, h * w).transpose(1, 2)
    seq = _linear(seq, p["proj_in"])
    all_probs = []
    for bp in p["blocks"]:
        normed = _ln(seq, bp["norm1"])
        seq = seq + _attention(bp["attn1"], normed, normed, num_heads)[0]
        ca, probs = _attention(bp["attn2"], _ln(seq, bp["norm2"]), context, num_heads)
        seq = seq + ca
        seq = seq + _geglu_ff(bp, _ln(seq, bp["norm3"]))
        all_probs.append(probs)
    seq = _linear(seq, p["proj_out"])
    return x + seq.transpose(1, 2).reshape(b, c, h, w), all_probs


def unet_forward(
    params: Params,
    cfg: UNetConfig,
    latents: torch.Tensor,
    timesteps: torch.Tensor,
    context: torch.Tensor,
    text_embeds: Optional[torch.Tensor] = None,
    time_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """latents [B, 4, H, W], timesteps [B], context [B, T, context_dim] ->
    (the eps prediction, the cross-attention probabilities of every
    transformer block, each [B, heads, h*w, T] at its level's resolution).

    A "text_time" UNet (SDXL) also needs `text_embeds` [B, pooled_text_dim]
    and `time_ids` [B, 6] (original size, crop corner, target size)."""
    groups, eps = cfg.num_groups, cfg.norm_eps
    temb = _timesteps_embedding(timesteps, cfg.block_out_channels[0])
    temb = temb.to(params["time1"]["w"].dtype)
    temb = _linear(F.silu(_linear(temb, params["time1"])), params["time2"])
    if cfg.addition_embed_type == "text_time":
        if text_embeds is None or time_ids is None:
            raise ValueError("a text_time UNet (SDXL) needs text_embeds [B, pooled] and "
                             "time_ids [B, 6] added conditions")
        b = time_ids.shape[0]
        tid = _timesteps_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
        add = torch.cat([text_embeds.to(tid.dtype), tid.reshape(b, -1)], dim=-1)
        add = add.to(params["add1"]["w"].dtype)
        temb = temb + _linear(F.silu(_linear(add, params["add1"])), params["add2"])

    maps: List[torch.Tensor] = []
    h = _conv(latents, params["conv_in"])
    skips = [h]
    n_levels = len(cfg.block_out_channels)
    for i, block in enumerate(params["down"]):
        for j in range(cfg.layers_per_block):
            h = _resblock(block["resnets"][j], h, temb, groups, eps)
            if cfg.cross_attention_levels[i]:
                h, probs = _transformer_block(block["attentions"][j], h, context,
                                              cfg.attention_heads[i], groups)
                maps.extend(probs)
            skips.append(h)
        if i < n_levels - 1:
            h = _conv(h, block["downsample"], stride=2)
            skips.append(h)

    h = _resblock(params["mid"]["res1"], h, temb, groups, eps)
    h, probs = _transformer_block(params["mid"]["attn"], h, context, cfg.attention_heads[-1],
                                  groups)
    maps.extend(probs)
    h = _resblock(params["mid"]["res2"], h, temb, groups, eps)

    for k, block in enumerate(params["up"]):
        i = n_levels - 1 - k
        for j in range(cfg.layers_per_block + 1):
            h = _resblock(block["resnets"][j], torch.cat([h, skips.pop()], dim=1), temb,
                          groups, eps)
            if cfg.cross_attention_levels[i]:
                h, probs = _transformer_block(block["attentions"][j], h, context,
                                              cfg.attention_heads[i], groups)
                maps.extend(probs)
        if k < n_levels - 1:
            h = _conv(F.interpolate(h, scale_factor=2, mode="nearest"), block["upsample"])

    h = _conv(F.silu(_gn(h, params["norm_out"], groups, eps)), params["conv_out"])
    return h, maps


def init_unet_params(
    generator: torch.Generator,
    cfg: UNetConfig,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
) -> Params:
    """Random parameters in the JAX package's scales (conv and linear
    weights N(0, 1/fan_in), zero biases, unit norms) on the generator's
    device. `device="meta"` makes shapes only, without drawing."""
    device = torch.device(device) if device is not None else generator.device
    meta = device.type == "meta"

    def normal(shape, fan: int):
        if meta:
            return torch.empty(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x / fan**0.5).to(dtype)

    def const(shape, value: float):
        return torch.full(shape, value, dtype=dtype, device=device)

    def conv(cin, cout, k=3):
        return {"w": normal((cout, cin, k, k), cin * k * k), "b": const((cout,), 0.0)}

    def lin(cin, cout, bias=True):
        p = {"w": normal((cin, cout), cin)}
        if bias:
            p["b"] = const((cout,), 0.0)
        return p

    def norm(c):
        return {"scale": const((c,), 1.0), "bias": const((c,), 0.0)}

    tdim = cfg.block_out_channels[0] * 4

    def res(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cin, cout), "time_emb": lin(tdim, cout),
             "norm2": norm(cout), "conv2": conv(cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(cin, cout, k=1)
        return p

    def basic_block(c):
        return {
            "norm1": norm(c),
            "attn1": {"q": lin(c, c, False), "k": lin(c, c, False), "v": lin(c, c, False),
                      "proj": lin(c, c)},
            "norm2": norm(c),
            "attn2": {"q": lin(c, c, False), "k": lin(cfg.context_dim, c, False),
                      "v": lin(cfg.context_dim, c, False), "proj": lin(c, c)},
            "norm3": norm(c),
            "ff_in": lin(c, 8 * c),
            "ff_out": lin(4 * c, c),
        }

    def attn(c, n_blocks):
        return {"norm": norm(c), "proj_in": lin(c, c),
                "blocks": [basic_block(c) for _ in range(n_blocks)], "proj_out": lin(c, c)}

    chans = cfg.block_out_channels
    n_levels = len(chans)
    down = []
    c_prev = chans[0]
    for i, c_out in enumerate(chans):
        block: Params = {"resnets": [res(c_prev if j == 0 else c_out, c_out)
                                     for j in range(cfg.layers_per_block)]}
        if cfg.cross_attention_levels[i]:
            block["attentions"] = [attn(c_out, cfg.tlayers(i))
                                   for _ in range(cfg.layers_per_block)]
        if i < n_levels - 1:
            block["downsample"] = conv(c_out, c_out)
        down.append(block)
        c_prev = c_out

    mid = {"res1": res(c_prev, c_prev), "attn": attn(c_prev, cfg.tlayers(n_levels - 1)),
           "res2": res(c_prev, c_prev)}

    # The skips' channels in push order: conv_in, then per level its resnets
    # and its downsampler; the up path pops them from the end.
    skip_chans = [chans[0]]
    for i in range(n_levels):
        skip_chans += [chans[i]] * cfg.layers_per_block
        if i < n_levels - 1:
            skip_chans.append(chans[i])
    up = []
    for k in range(n_levels):
        i = n_levels - 1 - k
        c_out = chans[i]
        block = {"resnets": []}
        for _ in range(cfg.layers_per_block + 1):
            block["resnets"].append(res(c_prev + skip_chans.pop(), c_out))
            c_prev = c_out
        if cfg.cross_attention_levels[i]:
            block["attentions"] = [attn(c_out, cfg.tlayers(i))
                                   for _ in range(cfg.layers_per_block + 1)]
        if k < n_levels - 1:
            block["upsample"] = conv(c_out, c_out)
        up.append(block)

    out = {"time1": lin(chans[0], tdim), "time2": lin(tdim, tdim),
           "conv_in": conv(cfg.in_channels, chans[0]), "down": down, "mid": mid, "up": up,
           "norm_out": norm(c_prev), "conv_out": conv(c_prev, cfg.out_channels)}
    if cfg.addition_embed_type == "text_time":
        out["add1"] = lin(cfg.projection_class_embeddings_input_dim, tdim)
        out["add2"] = lin(tdim, tdim)
    return out
