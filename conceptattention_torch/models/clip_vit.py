"""open_clip-compatible CLIP (the ViT-H/14 class) with a closed-form PRS
decomposition.

Counterpart of the JAX package's `models/clip_vit.py`. The TextSpan
baseline needs, for every image token, its contribution to the CLS
representation summed over layers and heads, with the final LayerNorm
linearised around the CLS token's statistics and projected into the shared
image-text space. One loop over the blocks carries the residual stream and
an f32 accumulator of the per-token CLS contributions; the linearisation is
an affine map applied once to the accumulated sum.

LayerNorms use eps 1e-5 and normalise in f32; the MLPs use the exact (erf)
GELU, or quick-GELU for OpenAI checkpoints. Parameters are the JAX
package's tree (linear weights [in, out], the packed in_proj in (3, heads,
head_dim) output order, blocks stacked by depth); the converters read
open_clip's key names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.models.flux.params import _Init, layer, stack_layers
from conceptattention_torch.models.vit import patchify
from conceptattention_torch.weights.convert import StateDict


@dataclasses.dataclass(frozen=True)
class OpenCLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024
    in_channels: int = 3
    # open_clip ViT-H/14 uses the exact GELU; quick_gelu only for OpenAI checkpoints.
    quick_gelu: bool = False
    ln_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class OpenCLIPTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024
    quick_gelu: bool = False
    ln_eps: float = 1e-5


VIT_H_14 = OpenCLIPVisionConfig()
VIT_H_14_TEXT = OpenCLIPTextConfig()


def _ln(x, p, eps: float):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _gelu(x, quick: bool):
    return x * torch.sigmoid(1.702 * x) if quick else F.gelu(x)


def _qkv_split(x, p, num_heads: int):
    """[B, N, D] -> q, k, v, each [B, H, N, hd] (the packed in_proj's
    (3, heads, head_dim) output order)."""
    b, n, d = x.shape
    qkv = (x @ p["qkv"]["w"] + p["qkv"]["b"]).reshape(b, n, 3, num_heads, d // num_heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _mlp(p, x, eps: float, quick: bool):
    h = _gelu(_ln(x, p["ln2"], eps) @ p["fc1"]["w"] + p["fc1"]["b"], quick)
    return x + h @ p["fc2"]["w"] + p["fc2"]["b"]


def _block_with_cls_contrib(p, cfg: OpenCLIPVisionConfig, x, with_contrib: bool = True):
    """A pre-LN block; with `with_contrib`, also each source token's
    contribution to the CLS attention output, summed over heads, with the
    out-projection's bias spread as bias/N per token: [B, N, D] in f32
    (else None)."""
    q, k, v = _qkv_split(_ln(x, p["ln1"], cfg.ln_eps), p, cfg.num_heads)
    hd = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits / (hd**0.5), dim=-1).to(v.dtype)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    b, _, n, _ = attn.shape
    attn_out = attn.permute(0, 2, 1, 3).reshape(b, n, cfg.width) @ p["out"]["w"] + p["out"]["b"]

    cls_contrib = None
    if with_contrib:
        # token m via head h: probs[b, h, 0, m] * v[b, h, m] @ W_O[h], heads summed
        w_o = p["out"]["w"].reshape(cfg.num_heads, hd, cfg.width)
        cls_contrib = torch.einsum("bhm,bhmd,hde->bme", probs[:, :, 0, :].float(), v.float(),
                                   w_o.float())
        cls_contrib = cls_contrib + p["out"]["b"].float() / n
    return _mlp(p, x + attn_out, cfg.ln_eps, cfg.quick_gelu), cls_contrib


def _embed_patches(params, cfg: OpenCLIPVisionConfig, images):
    x = patchify(images, cfg.patch_size) @ params["patch_embed"]["w"]  # conv1 has no bias
    cls = params["cls_token"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][: x.shape[1]]
    return _ln(x, params["ln_pre"], cfg.ln_eps)


def _project_cls(params, cfg: OpenCLIPVisionConfig, x):
    """The CLS token's final LayerNorm and projection in f32: (the
    representation [B, embed_dim], the token's mean and std [B, 1])."""
    pooled = x[:, 0].float()
    mean = pooled.mean(dim=-1, keepdim=True)
    std = torch.sqrt(pooled.var(dim=-1, keepdim=True, unbiased=False) + cfg.ln_eps)
    post = params["ln_post"]
    rep = ((pooled - mean) / std * post["scale"].float() + post["bias"].float()) \
        @ params["proj"].float()
    return rep, mean, std


def encode_image(params, cfg: OpenCLIPVisionConfig, images) -> torch.Tensor:
    """[B, 3, H, W] -> the CLS representation in the shared space [B,
    embed_dim] (open_clip `encode_image(normalize=False)`), without the
    decomposition."""
    x = _embed_patches(params, cfg, images)
    for i in range(cfg.depth):
        x, _ = _block_with_cls_contrib(layer(params["blocks"], i), cfg, x, with_contrib=False)
    return _project_cls(params, cfg, x)[0]


def prs_decomposition(params, cfg: OpenCLIPVisionConfig, images) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """The forward and its PRS attention decomposition: (representation [B,
    embed_dim], collapsed [B, N, embed_dim]), where collapsed[b, m] is token
    m's projected, LN-linearised, norm-divided contribution to the CLS
    representation summed over layers and heads. Token 0 is CLS."""
    x = _embed_patches(params, cfg, images)
    b, n, _ = x.shape
    acc = torch.zeros((b, n, cfg.width), dtype=torch.float32, device=x.device)
    for i in range(cfg.depth):
        x, contrib = _block_with_cls_contrib(layer(params["blocks"], i), cfg, x)
        acc = acc + contrib
    rep, mean, std = _project_cls(params, cfg, x)

    # Each of the L*H per-(layer, head) terms subtracts mean/(len_int*N*H)
    # and adds bias/(len_int*N*H); summed over layers and heads that is
    # mean*L/(len_int*N) and bias*L/(len_int*N), with len_int = 2L + 1
    # intermediates (L attentions, L MLPs and the ln_pre output).
    depth = params["blocks"]["ln1"]["scale"].shape[0]
    frac = depth / ((2 * depth + 1) * n)
    post = params["ln_post"]
    collapsed = ((acc - mean[:, None, :] * frac) * post["scale"].float() / std[:, None, :]
                 + post["bias"].float() * frac) @ params["proj"].float()
    return rep, collapsed / rep.norm(dim=-1)[:, None, None]


def text_encode(params, cfg: OpenCLIPTextConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """open_clip's text transformer: causal blocks, ln_final, pooled at the
    argmax token id (EOT has the highest id), @ text_projection. [B,
    embed_dim], not normalised."""
    n = input_ids.shape[1]
    x = params["token_embed"][input_ids] + params["pos_embed"][:n]
    causal = torch.triu(torch.full((n, n), -1e9, dtype=torch.float32, device=x.device),
                        diagonal=1)
    for i in range(cfg.depth):
        p = layer(params["blocks"], i)
        q, k, v = _qkv_split(_ln(x, p["ln1"], cfg.ln_eps), p, cfg.num_heads)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits / (q.shape[-1] ** 0.5) + causal, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        merged = attn.permute(0, 2, 1, 3).reshape(x.shape[0], n, cfg.width)
        x = _mlp(p, x + merged @ p["out"]["w"] + p["out"]["b"], cfg.ln_eps, cfg.quick_gelu)
    x = _ln(x, params["ln_final"], cfg.ln_eps)
    pooled = x[torch.arange(x.shape[0], device=x.device), input_ids.argmax(dim=-1)]
    return pooled @ params["text_projection"]


# ---------------------------------------------------------------------------
# open_clip state dicts -> parameter trees
# ---------------------------------------------------------------------------

def _blocks_from_sd(s: StateDict, prefix: str, depth: int) -> Dict[str, Any]:
    """The resblocks stacked by depth: torch Linear weights [out, in]
    transposed, the packed in_proj keeping its (3, H, hd) output order."""

    def ln(key):
        return {"scale": s(f"{key}.weight"), "bias": s(f"{key}.bias")}

    def block(i):
        base = f"{prefix}.{i}"
        return {
            "ln1": ln(f"{base}.ln_1"),
            "qkv": {"w": s(f"{base}.attn.in_proj_weight", transpose=True),
                    "b": s(f"{base}.attn.in_proj_bias")},
            "out": s.linear(f"{base}.attn.out_proj"),
            "ln2": ln(f"{base}.ln_2"),
            "fc1": s.linear(f"{base}.mlp.c_fc"),
            "fc2": s.linear(f"{base}.mlp.c_proj"),
        }

    return stack_layers(block, depth)


def convert_open_clip_visual(sd: Mapping[str, Any], cfg: OpenCLIPVisionConfig,
                             dtype: torch.dtype = torch.float32,
                             device: Optional[torch.device] = None) -> Dict[str, Any]:
    """open_clip `visual.*` keys -> the vision tree. conv1 [D, C, p, p]
    flattens to the (c, py, px) patch order of `patchify`."""
    s = StateDict(sd, dtype, device)
    conv = s("visual.conv1.weight")
    return {
        "patch_embed": {"w": conv.reshape(conv.shape[0], -1).t().contiguous()},
        "cls_token": s("visual.class_embedding"),
        "pos_embed": s("visual.positional_embedding"),
        "ln_pre": {"scale": s("visual.ln_pre.weight"), "bias": s("visual.ln_pre.bias")},
        "blocks": _blocks_from_sd(s, "visual.transformer.resblocks", cfg.depth),
        "ln_post": {"scale": s("visual.ln_post.weight"), "bias": s("visual.ln_post.bias")},
        "proj": s("visual.proj"),
    }


def convert_open_clip_text(sd: Mapping[str, Any], cfg: OpenCLIPTextConfig,
                           dtype: torch.dtype = torch.float32,
                           device: Optional[torch.device] = None) -> Dict[str, Any]:
    """open_clip's text-tower keys -> the text tree."""
    s = StateDict(sd, dtype, device)
    return {
        "token_embed": s("token_embedding.weight"),
        "pos_embed": s("positional_embedding"),
        "blocks": _blocks_from_sd(s, "transformer.resblocks", cfg.depth),
        "ln_final": {"scale": s("ln_final.weight"), "bias": s("ln_final.bias")},
        "text_projection": s("text_projection"),
    }


def init_open_clip_params(generator: torch.Generator, vis: OpenCLIPVisionConfig,
                          txt: Optional[OpenCLIPTextConfig] = None,
                          dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters on the generator's device, in the JAX package's
    scales; the text tower is included when a text config is given."""
    init = _Init(generator, dtype)

    def ln(d):
        return {"scale": init.const((d,), 1.0), "bias": init.const((d,), 0.0)}

    def blocks(width, depth, mlp_ratio):
        m = int(width * mlp_ratio)
        return stack_layers(lambda _: {
            "ln1": ln(width), "qkv": init.linear(width, 3 * width),
            "out": init.linear(width, width), "ln2": ln(width),
            "fc1": init.linear(width, m), "fc2": init.linear(m, width)}, depth)

    params = {"visual": {
        "patch_embed": {"w": init.normal((vis.in_channels * vis.patch_size**2, vis.width),
                                         vis.width**-0.5)},
        "cls_token": init.normal((vis.width,), 0.02),
        "pos_embed": init.normal((vis.num_tokens, vis.width), 0.02),
        "ln_pre": ln(vis.width),
        "blocks": blocks(vis.width, vis.depth, vis.mlp_ratio),
        "ln_post": ln(vis.width),
        "proj": init.normal((vis.width, vis.embed_dim), vis.width**-0.5),
    }}
    if txt is not None:
        params["text"] = {
            "token_embed": init.normal((txt.vocab_size, txt.width), 0.02),
            "pos_embed": init.normal((txt.context_length, txt.width), 0.01),
            "blocks": blocks(txt.width, txt.depth, txt.mlp_ratio),
            "ln_final": ln(txt.width),
            "text_projection": init.normal((txt.width, txt.embed_dim), txt.width**-0.5),
        }
    return params
