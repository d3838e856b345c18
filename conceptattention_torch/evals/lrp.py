"""Epsilon-LRP (alpha1-beta0) relevance propagation for the ViT.

Counterpart of the JAX package's `evals/lrp.py`: the Chefer relevance rules
applied in reverse over a captured forward pass of `models/vit.py`:
  - Linear: alpha1-beta0 (z+ with the negative-weight term);
  - the matmuls q@kT and A@V: S = R/Z redistributed, halved per operand;
  - Add (the residuals): a per-element split, then each branch rescaled so
    the sum of R is kept, in proportion to |branch sums|, per sample;
  - Clone: relevance summed over the branches; LayerNorm, GELU, softmax:
    identity;
  - the patch embedding: the zB rule with per-image bounds;
  - the CLS pool: scattered back to token 0.
The attention gradients of the gradient-weighted methods come from
`torch.autograd.grad` of the target logit with respect to a zero
`attn_deltas` stack (`models/vit.py`). Everything is computed in the
inputs' dtype (f32 for the zoo): the relevance maps amplify every
difference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from conceptattention_torch.models.flux.params import layer
from conceptattention_torch.models.vit import ViTConfig, patchify, vit_forward
from conceptattention_torch.ops.norms import layer_norm


def safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b with tiny denominators pushed to +-1e-9 and exact zeros of b
    giving 0: den = max(b, 1e-9) + min(b, 1e-9)."""
    den = torch.clamp(b, min=1e-9) + torch.clamp(b, max=1e-9)
    den = den + (den == 0).to(den.dtype) * 1e-9
    return a / den * (b != 0).to(b.dtype)


def _linear_relprop(R, x, w):
    """alpha1-beta0 Linear rule; w is [din, dout]."""
    pw, nw = w.clamp(min=0), w.clamp(max=0)
    px, nx = x.clamp(min=0), x.clamp(max=0)
    z = px @ pw + nx @ nw
    s = safe_divide(R, z)
    return px * (s @ pw.T) + nx * (s @ nw.T)


def _matmul2_relprop(R, attn, v):
    """The A@V rule (per operand, halved)."""
    z = torch.einsum("bhij,bhjd->bhid", attn, v)
    s = safe_divide(R, z)
    r_attn = attn * torch.einsum("bhid,bhjd->bhij", s, v) / 2
    r_v = v * torch.einsum("bhij,bhid->bhjd", attn, s) / 2
    return r_attn, r_v


def _matmul1_relprop(R, q, k):
    """The q@kT rule (on the unscaled product)."""
    z = torch.einsum("bhid,bhjd->bhij", q, k)
    s = safe_divide(R, z)
    r_q = q * torch.einsum("bhij,bhjd->bhid", s, k) / 2
    r_k = k * torch.einsum("bhij,bhid->bhjd", s, q) / 2
    return r_q, r_k


def _add_relprop(R, a_in, b_in):
    """The residual-add rule. Every sum is per sample, so a batch does not
    couple its images through the rescale factors."""
    s = safe_divide(R, a_in + b_in)
    a, b = a_in * s, b_in * s
    dims = tuple(range(1, R.ndim))

    def psum(x):
        return x.sum(dim=dims, keepdim=True)

    a_sum, b_sum = psum(a), psum(b)
    denom = a_sum.abs() + b_sum.abs()
    a_fact = safe_divide(a_sum.abs(), denom) * psum(R)
    b_fact = safe_divide(b_sum.abs(), denom) * psum(R)
    return a * safe_divide(a_fact, psum(a)), b * safe_divide(b_fact, psum(b))


def _clone_relprop(Rs, x):
    return x * sum(safe_divide(r, x) for r in Rs)


def _zb_relprop(R, x, w):
    """The input layer's zB rule; x [B, N, Din], w [Din, Dout]. The bounds
    are each image's min and max over all its elements."""
    pw, nw = w.clamp(min=0), w.clamp(max=0)
    lo = x.amin(dim=(1, 2), keepdim=True) * torch.ones_like(x)
    hi = x.amax(dim=(1, 2), keepdim=True) * torch.ones_like(x)
    za = x @ w - lo @ pw - hi @ nw + 1e-9
    s = R / za
    return x * (s @ w.T) - lo * (s @ pw.T) - hi * (s @ nw.T)


def _capture_forward(params, cfg: ViTConfig, images) -> Dict[str, Any]:
    """The forward of `models/vit.py`, recording every tensor the relevance
    rules read."""
    b = images.shape[0]
    patches = patchify(images, cfg.patch_size)
    x = patches @ params["patch_embed"]["w"] + params["patch_embed"]["b"]
    cls = params["cls_token"].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    embed_out = x
    x = x + params["pos_embed"][:, : x.shape[1]]

    cap: Dict[str, Any] = {"patches": patches, "embed_out": embed_out, "blocks": []}
    hd = cfg.hidden_size // cfg.num_heads
    for i in range(cfg.depth):
        p = layer(params["blocks"], i)
        c: Dict[str, Any] = {"x_in": x}
        n1 = layer_norm(x, eps=1e-6) * p["norm1"]["scale"] + p["norm1"]["bias"]
        c["norm1_out"] = n1
        qkv = (n1 @ p["attn"]["qkv"]["w"] + p["attn"]["qkv"]["b"]).reshape(
            b, -1, 3, cfg.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        c["q"], c["k"], c["v"] = q, k, v
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * (hd**-0.5), dim=-1)
        c["attn"] = attn
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        merged = out.permute(0, 2, 1, 3).reshape(b, -1, cfg.hidden_size)
        c["attn_merged"] = merged
        x = x + (merged @ p["attn"]["proj"]["w"] + p["attn"]["proj"]["b"])
        c["x_mid"] = x
        n2 = layer_norm(x, eps=1e-6) * p["norm2"]["scale"] + p["norm2"]["bias"]
        c["norm2_out"] = n2
        h2 = F.gelu(n2 @ p["mlp_in"]["w"] + p["mlp_in"]["b"], approximate="tanh")
        c["mlp_act"] = h2
        x = x + (h2 @ p["mlp_out"]["w"] + p["mlp_out"]["b"])
        cap["blocks"].append(c)

    xn = layer_norm(x, eps=cfg.final_norm_eps) * params["norm"]["scale"] + params["norm"]["bias"]
    cap["norm_out"] = xn
    cap["head_in"] = xn[:, 0]
    cap["logits"] = cap["head_in"] @ params["head"]["w"] + params["head"]["b"]
    return cap


def _attn_gradients(params, cfg: ViTConfig, images, index, return_attn: bool = False):
    """d(logit[index])/dA for every layer, [depth, B, H, N, N], from
    autograd of the logit with respect to a zero additive delta on the
    attention probabilities; with `return_attn`, also the attention stack of
    that forward. Runs with autograd whatever the caller's mode (the inputs
    are cloned: a tensor made under `torch.inference_mode` cannot be saved
    for backward)."""
    n = cfg.num_patches + 1
    with torch.inference_mode(False), torch.enable_grad():
        deltas = torch.zeros((cfg.depth, images.shape[0], cfg.num_heads, n, n),
                             dtype=images.dtype, device=images.device, requires_grad=True)
        logits, attns = vit_forward(params, cfg, images.clone(), return_attn=True,
                                    attn_deltas=deltas)
        score = logits.gather(-1, index[:, None].clone()).sum()
        (grads,) = torch.autograd.grad(score, deltas)
    return (grads, attns.detach()) if return_attn else grads


def _rollout(cams: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
    """The relevance methods' rollout: a product of raw (A + I) matrices,
    without the row normalisation of `baselines.attention_rollout`."""
    a = cams + torch.eye(cams.shape[-1], dtype=cams.dtype, device=cams.device)[None]
    joint = a[start_layer]
    for i in range(start_layer + 1, a.shape[0]):
        joint = a[i] @ joint
    return joint


def vit_relprop(
    params,
    cfg: ViTConfig,
    images: torch.Tensor,
    index: Optional[torch.Tensor] = None,
    method: str = "transformer_attribution",
    start_layer: int = 0,
    is_ablation: bool = False,
) -> torch.Tensor:
    """Relevance of `index`'s logit (the argmax by default).

    Returns [B, N] patch relevance for rollout, transformer_attribution
    (alias grad), last_layer, last_layer_attn and second_layer; [B, H_img,
    W_img] pixel relevance for "full"."""
    cap = _capture_forward(params, cfg, images)
    logits = cap["logits"]
    if index is None:
        index = logits.argmax(dim=-1)
    b, n_cls = logits.shape
    one_hot = F.one_hot(index, n_cls).to(logits.dtype)

    # head -> CLS pool -> final norm (identity)
    R = _linear_relprop(one_hot, cap["head_in"], params["head"]["w"])[:, None, :]
    z = cap["norm_out"][:, 0:1]
    R = F.pad(z * safe_divide(R, z), (0, 0, 0, cap["norm_out"].shape[1] - 1))

    hd = cfg.hidden_size // cfg.num_heads
    attn_cams: List[torch.Tensor] = [None] * cfg.depth
    for i in reversed(range(cfg.depth)):
        p = layer(params["blocks"], i)
        c = cap["blocks"][i]
        mlp_out = c["mlp_act"] @ p["mlp_out"]["w"] + p["mlp_out"]["b"]
        cam1, cam2 = _add_relprop(R, c["x_mid"], mlp_out)
        cam2 = _linear_relprop(cam2, c["mlp_act"], p["mlp_out"]["w"])
        cam2 = _linear_relprop(cam2, c["norm2_out"], p["mlp_in"]["w"])
        R = _clone_relprop([cam1, cam2], c["x_mid"])

        attn_out = c["attn_merged"] @ p["attn"]["proj"]["w"] + p["attn"]["proj"]["b"]
        cam1, cam2 = _add_relprop(R, c["x_in"], attn_out)
        cam2 = _linear_relprop(cam2, c["attn_merged"], p["attn"]["proj"]["w"])
        cam2 = cam2.reshape(b, -1, cfg.num_heads, hd).permute(0, 2, 1, 3)
        cam_attn, cam_v = _matmul2_relprop(cam2, c["attn"], c["v"])
        attn_cams[i] = cam_attn
        cam_q, cam_k = _matmul1_relprop(cam_attn, c["q"], c["k"])
        cam_qkv = torch.stack([cam_q, cam_k, cam_v]).permute(1, 3, 0, 2, 4).reshape(
            b, -1, 3 * cfg.hidden_size)
        cam2 = _linear_relprop(cam_qkv, c["norm1_out"], p["attn"]["qkv"]["w"])
        R = _clone_relprop([cam1, cam2], c["x_in"])

    if method == "full":
        cam_x, _ = _add_relprop(R, cap["embed_out"],
                                params["pos_embed"].expand_as(cap["embed_out"]))
        cam_pix = _zb_relprop(cam_x[:, 1:], cap["patches"], params["patch_embed"]["w"])
        ps, g = cfg.patch_size, cfg.grid
        cam_pix = cam_pix.reshape(b, g, g, cfg.in_channels, ps, ps).permute(0, 3, 1, 4, 2, 5)
        return cam_pix.reshape(b, cfg.in_channels, g * ps, g * ps).sum(dim=1)

    if method == "rollout":
        cams = torch.stack([c.clamp(min=0).mean(dim=1) for c in attn_cams])
        return _rollout(cams, start_layer)[:, 0, 1:]

    if method in ("transformer_attribution", "grad"):
        grads = _attn_gradients(params, cfg, images, index)
        cams = torch.stack([(g * c).clamp(min=0).mean(dim=1) for g, c in zip(grads, attn_cams)])
        return _rollout(cams, start_layer)[:, 0, 1:]

    if method in ("last_layer", "second_layer"):
        li = cfg.depth - 1 if method == "last_layer" else 1
        cam = attn_cams[li]
        if is_ablation:
            cam = cam * _attn_gradients(params, cfg, images, index)[li]
        return cam.clamp(min=0).mean(dim=1)[:, 0, 1:]

    if method == "last_layer_attn":
        return cap["blocks"][-1]["attn"].clamp(min=0).mean(dim=1)[:, 0, 1:]

    raise ValueError(f"unknown method {method!r}")
