"""Weights, text embeddings and seeds, all made by the benchmark from the seed.

Each tree is laid out as the measured program takes it (linear weights
[in, out]; qkv [in, 3, heads, head_dim]; the blocks stacked along a leading
depth axis; VAE convs OIHW) and drawn on the device, one `torch.randn` call
a stacked leaf, in the dtype it is served in: linear and conv weights
N(0, 1/fan_in), biases N(0, 0.02^2), norm scales one. The reference reads
the same tensors.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (weights, a call, an image)."""
    text = "\x00".join([str(int(seed)), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


class _Draw:
    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.gen = torch.Generator(device).manual_seed(seed)
        self.device, self.dtype = torch.device(device), dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return x.mul_(std)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def linear(self, d_in: int, d_out, depth=(), bias: bool = True) -> Dict:
        out = tuple(d_out) if isinstance(d_out, (tuple, list)) else (d_out,)
        p = {"w": self.normal((*depth, d_in, *out), d_in ** -0.5)}
        if bias:
            p["b"] = self.normal((*depth, *out), 0.02)
        return p


def flux_dit(seed: int, cfg: Dict, device, dtype=torch.bfloat16) -> Dict:
    """The Flux DiT tree. `cfg`: hidden, heads, head_dim, mlp_hidden,
    in_channels, context_in_dim, vec_in_dim, depth, depth_single."""
    r = _Draw(derive(seed, "flux-dit"), device, dtype)
    d, h, hd, m = cfg["hidden"], cfg["num_heads"], cfg["head_dim"], cfg["mlp_hidden"]
    n2, n1 = (cfg["depth"],), (cfg["depth_single"],)
    double = {}
    for s in ("img", "txt"):
        double.update({
            f"{s}_mod": r.linear(d, 6 * d, n2), f"{s}_qkv": r.linear(d, (3, h, hd), n2),
            f"{s}_qnorm": r.ones((*n2, hd)), f"{s}_knorm": r.ones((*n2, hd)),
            f"{s}_proj": r.linear(d, d, n2), f"{s}_mlp_in": r.linear(d, m, n2),
            f"{s}_mlp_out": r.linear(m, d, n2),
        })
    single = {
        "mod": r.linear(d, 3 * d, n1), "qkv": r.linear(d, (3, h, hd), n1),
        "mlp_in": r.linear(d, m, n1), "proj": r.linear(d, d, n1),
        "mlp_out": r.linear(m, d, n1, bias=False),
        "qnorm": r.ones((*n1, hd)), "knorm": r.ones((*n1, hd)),
    }
    return {
        "img_in": r.linear(cfg["in_channels"], d),
        "txt_in": r.linear(cfg["context_in_dim"], d),
        "time_in": {"in": r.linear(256, d), "out": r.linear(d, d)},
        "vector_in": {"in": r.linear(cfg["vec_in_dim"], d), "out": r.linear(d, d)},
        "final": {"adaln": r.linear(d, 2 * d), "linear": r.linear(d, cfg["in_channels"])},
        "double": double,
        "single": single,
    }


def flux_vae(seed: int, cfg: Dict, device, dtype=torch.float32) -> Dict:
    """The Flux VAE tree {encoder, decoder}. `cfg`: ch, ch_mult,
    num_res_blocks, z_channels, in_channels, out_ch."""
    r = _Draw(derive(seed, "flux-vae"), device, dtype)

    def conv(c_in, c_out, k):
        return {"w": r.normal((c_out, c_in, k, k), (c_in * k * k) ** -0.5),
                "b": r.normal((c_out,), 0.02)}

    def gn(c):
        return {"scale": r.ones((c,)), "bias": r.normal((c,), 0.02)}

    def resnet(c_in, c_out):
        p = {"norm1": gn(c_in), "conv1": conv(c_in, c_out, 3), "norm2": gn(c_out),
             "conv2": conv(c_out, c_out, 3)}
        if c_in != c_out:
            p["nin_shortcut"] = conv(c_in, c_out, 1)
        return p

    def attn(c):
        return {"norm": gn(c), **{n: conv(c, c, 1) for n in ("q", "k", "v", "proj_out")}}

    ch, mult, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    enc = {"conv_in": conv(cfg["in_channels"], ch, 3), "down": []}
    block_in = ch
    for i, mu in enumerate(mult):
        blocks = []
        for _ in range(nres):
            blocks.append(resnet(block_in, ch * mu))
            block_in = ch * mu
        level = {"block": blocks}
        if i != len(mult) - 1:
            level["downsample"] = {"conv": conv(block_in, block_in, 3)}
        enc["down"].append(level)
    enc.update(mid_block_1=resnet(block_in, block_in), mid_attn_1=attn(block_in),
               mid_block_2=resnet(block_in, block_in), norm_out=gn(block_in),
               conv_out=conv(block_in, 2 * cfg["z_channels"], 3))
    block_in = ch * mult[-1]
    dec = {"conv_in": conv(cfg["z_channels"], block_in, 3),
           "mid_block_1": resnet(block_in, block_in), "mid_attn_1": attn(block_in),
           "mid_block_2": resnet(block_in, block_in)}
    up: List = [None] * len(mult)
    for i in reversed(range(len(mult))):
        blocks = []
        for _ in range(nres + 1):
            blocks.append(resnet(block_in, ch * mult[i]))
            block_in = ch * mult[i]
        level = {"block": blocks}
        if i != 0:
            level["upsample"] = {"conv": conv(block_in, block_in, 3)}
        up[i] = level
    dec.update(up=up, norm_out=gn(block_in), conv_out=conv(block_in, cfg["out_ch"], 3))
    return {"encoder": enc, "decoder": dec}


def cogvideox_dit(seed: int, cfg: Dict, device, dtype=torch.bfloat16) -> Dict:
    """The CogVideoX DiT tree. `cfg`: hidden, head_dim, time_embed_dim,
    in_channels, out_channels, patch_size, text_embed_dim, num_layers."""
    r = _Draw(derive(seed, "cogvideox-dit"), device, dtype)
    d, te, hd, n = cfg["hidden"], cfg["time_embed_dim"], cfg["head_dim"], (cfg["num_layers"],)
    p = cfg["patch_size"]

    def ln(shape):
        return {"w": r.ones(shape), "b": r.normal(shape, 0.02)}

    blocks = {
        "norm1": {"ln": ln((*n, d)), "lin": r.linear(te, 6 * d, n)},
        "norm2": {"ln": ln((*n, d)), "lin": r.linear(te, 6 * d, n)},
        "qkv": r.linear(d, 3 * d, n), "qnorm": ln((*n, hd)), "knorm": ln((*n, hd)),
        "proj": r.linear(d, d, n), "ff_in": r.linear(d, 4 * d, n), "ff_out": r.linear(4 * d, d, n),
    }
    return {
        "patch_proj": r.linear(cfg["in_channels"] * p * p, d),
        "text_proj": r.linear(cfg["text_embed_dim"], d),
        "time_lin1": r.linear(d, te),
        "time_lin2": r.linear(te, te),
        "blocks": blocks,
        "norm_final": ln((d,)),
        "norm_out_ln": ln((d,)),
        "norm_out_lin": r.linear(te, 2 * d),
        "proj_out": r.linear(d, cfg["out_channels"] * p * p),
    }


class SeededTextEncoders:
    """Stands in for T5-XXL and CLIP-L (no weights of either are in the
    repository): each text's T5 states [t5_max_length, t5_dim] and CLIP
    pooled vector [clip_dim] are N(0, 1) draws on the device from a seed
    derived from the run's seed and the text, float32. Same interface as the
    program's text encoders; the program moves and casts what it gets."""

    def __init__(self, seed: int, device, t5_dim: int = 4096, clip_dim: int = 768,
                 t5_max_length: int = 256):
        self.seed, self.device = seed, torch.device(device)
        self.t5_dim, self.clip_dim, self.t5_max_length = t5_dim, clip_dim, t5_max_length

    def _draw(self, text: str, tag: str, shape) -> torch.Tensor:
        gen = torch.Generator(self.device).manual_seed(derive(self.seed, tag, text))
        x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        return x.to(torch.bfloat16).float()

    def encode_t5(self, prompts: List[str]) -> torch.Tensor:
        return torch.stack([self._draw(p, "t5", (self.t5_max_length, self.t5_dim))
                            for p in prompts])

    def encode_clip(self, prompts: List[str]) -> torch.Tensor:
        return torch.stack([self._draw(p, "clip", (self.clip_dim,)) for p in prompts])
