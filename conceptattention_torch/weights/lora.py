"""LoRA adapters for the Flux and CogVideoX DiTs: conversion and merging.

Counterpart of the JAX package's `weights/lora.py`. Three published namings
are read by `convert_lora_state_dict`:

  1. the BFL module tree with PEFT names (the official flux checkpoint's
     keys): `double_blocks.{i}.img_attn.qkv.lora_A.weight` (A: [r, in]),
     `...lora_B.weight` (B: [out, r]), `...alpha` (a scalar, optional);
  2. kohya sd-scripts over the same tree: '.' turned into '_' under a
     `lora_unet_` prefix, `lora_down` / `lora_up` for A / B;
  3. diffusers' `FluxTransformer2DModel` with PEFT names (optionally under
     `transformer.`): separate attn.to_q / to_k / to_v become one
     block-diagonal factor of the fused qkv, norm1.linear -> img_mod,
     ff.net.{0.proj,2} -> img_mlp_{in,out}, the *_context / add_* modules ->
     the txt stream, and the single block's proj_out input axis split as
     `weights/convert.py` splits linear2.

An adapter is a tree that mirrors the parameter tree, {"double": {leaf:
{"a", "b"}}, "single": {...}} (or {"blocks": ...} for CogVideoX), whose
factors are f32 tensors "a" [depth, in, R] and "b" [depth, R, out], alpha/r
folded into "b", each layer zero-padded to the largest rank. `merge_lora`
adds strength * a @ b to every targeted weight one layer at a time, in f32
on the device the weight lies on (or on `device`), and rounds once to the
weight's dtype; a quantized cell is dequantized, merged and requantized in
its own scheme and layout (w8 / w8a8 per (layer, out-channel) int8, the
w8a8 stacks input-axis-fastest; w4 group-wise int4 along the axis its
shapes name).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.ops.quant import (
    _absmax_int8,
    _input_axis_fastest,
    dequantize_w4,
    quantize_array_w4,
    w4_dims,
)

# ---------------------------------------------------------------------------
# key normalization

_KOHYA_MODULES = {
    # munged -> dotted (BFL module tree)
    "img_attn_qkv": "img_attn.qkv",
    "img_attn_proj": "img_attn.proj",
    "img_mod_lin": "img_mod.lin",
    "img_mlp_0": "img_mlp.0",
    "img_mlp_2": "img_mlp.2",
    "txt_attn_qkv": "txt_attn.qkv",
    "txt_attn_proj": "txt_attn.proj",
    "txt_mod_lin": "txt_mod.lin",
    "txt_mlp_0": "txt_mlp.0",
    "txt_mlp_2": "txt_mlp.2",
    "linear1": "linear1",
    "linear2": "linear2",
    "modulation_lin": "modulation.lin",
}

_KOHYA_RE = re.compile(r"^lora_(?:unet|transformer)_(double_blocks|single_blocks)_(\d+)_(.+)$")


def _normalize_key(key: str) -> Optional[Tuple[str, str]]:
    """A state-dict key -> (module path, part), part one of "a", "b",
    "alpha"; None for keys that are not LoRA tensors."""
    if key.endswith(".lora_A.weight") or key.endswith(".lora_down.weight"):
        part, module = "a", key.rsplit(".", 2)[0]
    elif key.endswith(".lora_B.weight") or key.endswith(".lora_up.weight"):
        part, module = "b", key.rsplit(".", 2)[0]
    elif key.endswith(".alpha"):
        part, module = "alpha", key[: -len(".alpha")]
    else:
        return None
    if module.startswith("transformer."):
        module = module[len("transformer."):]
    m = _KOHYA_RE.match(module)
    if m:
        blocks, idx, rest = m.groups()
        dotted = _KOHYA_MODULES.get(rest)
        if dotted is None:
            return None
        module = f"{blocks}.{idx}.{dotted}"
    return module, part


# ---------------------------------------------------------------------------
# module path -> (stack, layer, plan)
#
# A plan lists where one adapter module lands: (leaf, a_slice, b_slice,
# qkv_third) entries. The slices cut the fused axes as weights/convert.py
# splits the single block's linear1 (output axis) and linear2 (input axis);
# qkv_third places a separate to_q / to_k / to_v factor in the fused qkv.

_DOUBLE_BFL = {
    "img_attn.qkv": [("img_qkv", None, None, None)],
    "img_attn.proj": [("img_proj", None, None, None)],
    "img_mod.lin": [("img_mod", None, None, None)],
    "img_mlp.0": [("img_mlp_in", None, None, None)],
    "img_mlp.2": [("img_mlp_out", None, None, None)],
    "txt_attn.qkv": [("txt_qkv", None, None, None)],
    "txt_attn.proj": [("txt_proj", None, None, None)],
    "txt_mod.lin": [("txt_mod", None, None, None)],
    "txt_mlp.0": [("txt_mlp_in", None, None, None)],
    "txt_mlp.2": [("txt_mlp_out", None, None, None)],
}

_DOUBLE_DIFFUSERS = {
    "norm1.linear": [("img_mod", None, None, None)],
    "norm1_context.linear": [("txt_mod", None, None, None)],
    "attn.to_q": [("img_qkv", None, None, 0)],
    "attn.to_k": [("img_qkv", None, None, 1)],
    "attn.to_v": [("img_qkv", None, None, 2)],
    "attn.add_q_proj": [("txt_qkv", None, None, 0)],
    "attn.add_k_proj": [("txt_qkv", None, None, 1)],
    "attn.add_v_proj": [("txt_qkv", None, None, 2)],
    "attn.to_out.0": [("img_proj", None, None, None)],
    "attn.to_add_out": [("txt_proj", None, None, None)],
    "ff.net.0.proj": [("img_mlp_in", None, None, None)],
    "ff.net.2": [("img_mlp_out", None, None, None)],
    "ff_context.net.0.proj": [("txt_mlp_in", None, None, None)],
    "ff_context.net.2": [("txt_mlp_out", None, None, None)],
}

_SINGLE_DIFFUSERS = {
    "norm.linear": [("mod", None, None, None)],
    "attn.to_q": [("qkv", None, None, 0)],
    "attn.to_k": [("qkv", None, None, 1)],
    "attn.to_v": [("qkv", None, None, 2)],
    "proj_mlp": [("mlp_in", None, None, None)],
    # proj_out's input axis is [attn_out | mlp]: A's rows split as linear2's
    "proj_out": [("proj", "in_head", None, None), ("mlp_out", "in_tail", None, None)],
}


def _single_bfl_plan(module: str):
    if module == "modulation.lin":
        return [("mod", None, None, None)]
    if module in ("qkv", "mlp_in", "proj", "mlp_out"):
        # leaf names as they are: adapters trained against the split blocks
        return [(module, None, None, None)]
    if module == "linear1":  # output axis [qkv | mlp_in]: B's columns split at 3*hidden
        return [("qkv", None, "out_head", None), ("mlp_in", None, "out_tail", None)]
    if module == "linear2":
        return [("proj", "in_head", None, None), ("mlp_out", "in_tail", None, None)]
    return None


def _resolve(module: str):
    """module path -> (stack, layer index, plan), or None."""
    parts = module.split(".")
    if len(parts) < 3:
        return None
    rest = ".".join(parts[2:])
    plan, stack = None, None
    if parts[0] == "double_blocks":
        plan, stack = _DOUBLE_BFL.get(rest), "double"
    elif parts[0] == "single_blocks":
        plan, stack = _single_bfl_plan(rest), "single"
    elif parts[0] == "transformer_blocks":
        plan, stack = _DOUBLE_DIFFUSERS.get(rest), "double"
    elif parts[0] == "single_transformer_blocks":
        plan, stack = _SINGLE_DIFFUSERS.get(rest), "single"
    return (stack, int(parts[1]), plan) if plan else None


# ---------------------------------------------------------------------------
# conversion

def _f32(x) -> torch.Tensor:
    """A tensor (any device and dtype), numpy array or scalar as a CPU f32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _group_modules(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{module path: {part: tensor}} of the LoRA keys, text-encoder modules
    (which combined files may carry) left out."""
    grouped: Dict[str, Dict[str, Any]] = {}
    for key in sd.keys():
        norm = _normalize_key(key)
        if norm is None:
            continue
        module, part = norm
        if module.split(".")[0].startswith(("te", "text_encoder", "lora_te")):
            continue
        grouped.setdefault(module, {})[part] = sd[key]
    return grouped


def _factors(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a [in, r], b [r, out] * alpha / r) of one module's A, B and alpha."""
    a, b = _f32(parts["a"]), _f32(parts["b"])  # [r, in], [out, r]
    r = a.shape[0]
    alpha = float(_f32(parts["alpha"])) if "alpha" in parts else float(r)
    return a.T, b.T * (alpha / r)


def _unmatched_error(what: str, unmatched: List[str]) -> ValueError:
    more = "..." if len(unmatched) > 8 else ""
    return ValueError(f"unrecognized {what}LoRA modules (pass strict=False to skip): "
                      f"{unmatched[:8]}{more}")


def convert_lora_state_dict(sd: Mapping[str, Any], cfg: FluxConfig,
                            strict: bool = True) -> Dict[str, Any]:
    """A LoRA state dict (torch tensors or numpy arrays) -> the adapter tree
    {"double": {leaf: {"a", "b"}}, "single": {...}} of CPU f32 factors
    ([depth, in, R], [depth, R, out], alpha/r folded into b). Layers an
    adapter does not touch get zero factors; per-layer ranks are zero-padded
    to the largest. `strict` raises on LoRA modules that name no known
    weight (text-encoder modules are always skipped)."""
    d = cfg.hidden_size
    accum: Dict[Tuple[str, str], Dict[int, List]] = {}
    unmatched: List[str] = []
    for module, parts in _group_modules(sd).items():
        resolved = _resolve(module) if "a" in parts and "b" in parts else None
        if resolved is None:
            unmatched.append(module)
            continue
        stack, layer, plan = resolved
        a_t, b_t = _factors(parts)
        for leaf, a_slice, b_slice, third in plan:
            av, bv = a_t, b_t
            if a_slice == "in_head":
                av = a_t[:d]
            elif a_slice == "in_tail":
                av = a_t[d:]
            if b_slice == "out_head":
                bv = b_t[:, : 3 * d]
            elif b_slice == "out_tail":
                bv = b_t[:, 3 * d:]
            accum.setdefault((stack, leaf), {}).setdefault(layer, []).append((av, bv, third))
    if strict and unmatched:
        raise _unmatched_error("", unmatched)
    return _stack_accum(accum, {"double": cfg.depth, "single": cfg.depth_single_blocks})


def _stack_accum(accum: Dict[Tuple[str, str], Dict[int, List]],
                 depths: Dict[str, int]) -> Dict[str, Any]:
    """Per-layer (a, b, third) factor lists -> [depth, in, R] / [depth, R,
    out] stacks: untouched layers zero, ranks zero-padded to the largest,
    and separate q / k / v thirds one block-diagonal factor of the fused
    output axis (a concatenated over ranks, each third's b in its own
    columns)."""
    out: Dict[str, Any] = {stack: {} for stack in depths}
    for (stack, leaf), layers in accum.items():
        depth = depths[stack]
        per_layer: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = []
        for i in range(depth):
            factors = layers.get(i, [])
            if not factors:
                per_layer.append(None)
            elif any(t is not None for _, _, t in factors):
                a_parts, b_parts = [], []
                for av, bv, third in sorted(factors, key=lambda f: f[2]):
                    d_out = bv.shape[1]  # one third's output width
                    full = torch.zeros(bv.shape[0], 3 * d_out)
                    full[:, third * d_out:(third + 1) * d_out] = bv
                    a_parts.append(av)
                    b_parts.append(full)
                per_layer.append((torch.cat(a_parts, dim=1), torch.cat(b_parts, dim=0)))
            else:
                av, bv, _ = factors[0]
                per_layer.append((av, bv))
        present = [ab for ab in per_layer if ab is not None]
        in_dim, out_dim = present[0][0].shape[0], present[0][1].shape[1]
        rank = max(a.shape[1] for a, _ in present)
        a_stack = torch.zeros(depth, in_dim, rank)
        b_stack = torch.zeros(depth, rank, out_dim)
        for i, ab in enumerate(per_layer):
            if ab is not None:
                a_stack[i, :, : ab[0].shape[1]] = ab[0]
                b_stack[i, : ab[1].shape[0]] = ab[1]
        out[stack][leaf] = {"a": a_stack, "b": b_stack}
    return out


def load_lora(path: str, cfg: FluxConfig, strict: bool = True) -> Dict[str, Any]:
    """A LoRA `.safetensors` file -> an adapter tree (CPU f32 factors)."""
    from conceptattention_torch.weights.convert import load_safetensors

    return convert_lora_state_dict(load_safetensors(path), cfg, strict=strict)


# CogVideoX adapters: diffusers `CogVideoXTransformer3DModel` module names
# onto the tree of `convert_cogvideox_state_dict` (qkv [D, 3D], to_q | to_k |
# to_v along the output axis).
_VIDEO_MODULES = {
    "attn1.to_q": ("qkv", 0),
    "attn1.to_k": ("qkv", 1),
    "attn1.to_v": ("qkv", 2),
    "attn1.to_out.0": ("proj", None),
    "ff.net.0.proj": ("ff_in", None),
    "ff.net.2": ("ff_out", None),
    "norm1.linear": ("norm1.lin", None),
    "norm2.linear": ("norm2.lin", None),
}


def convert_cogvideox_lora_state_dict(sd: Mapping[str, Any], cfg,
                                      strict: bool = True) -> Dict[str, Any]:
    """A diffusers-named CogVideoX LoRA state dict -> {"blocks": {leaf}}
    (cfg a `CogVideoXConfig`, depth cfg.num_layers): separate to_q / to_k /
    to_v factors become one block-diagonal factor of the fused qkv."""
    accum: Dict[Tuple[str, str], Dict[int, List]] = {}
    unmatched: List[str] = []
    for module, parts in _group_modules(sd).items():
        mp = module.split(".")
        target = None
        if mp[0] == "transformer_blocks" and len(mp) >= 3:
            target = _VIDEO_MODULES.get(".".join(mp[2:]))
        if target is None or "a" not in parts or "b" not in parts:
            unmatched.append(module)
            continue
        leaf, third = target
        a_t, b_t = _factors(parts)
        accum.setdefault(("blocks", leaf), {}).setdefault(int(mp[1]), []).append((a_t, b_t, third))
    if strict and unmatched:
        raise _unmatched_error("CogVideoX ", unmatched)
    return _stack_accum(accum, {"blocks": cfg.num_layers})


# ---------------------------------------------------------------------------
# merging

DeviceLike = Union[str, torch.device, None]


def _requantize_like(wq: Dict[str, torch.Tensor], merged: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One merged f32 layer [in, out...] in the scheme of the cell `wq`'s
    layer: group-wise int4 for {q4p, gscale} (along the cell's group axis),
    per-out-channel int8 for {q | qa, scale}."""
    if "q4p" in wq:
        ax, _, group = w4_dims(wq)
        return quantize_array_w4(merged, axis=ax - 1, group_size=group)
    cell = _absmax_int8(merged, 0, wq["scale"].dtype)
    return {("qa" if "qa" in wq else "q"): cell["q"], "scale": cell["scale"]}


def _dequantized_layer(w: Dict[str, torch.Tensor], i: int, device) -> torch.Tensor:
    """Layer i of a quantized cell as a dense f32 weight on `device`."""
    if "q4p" in w:
        return dequantize_w4({"q4p": w["q4p"][i].to(device), "gscale": w["gscale"][i].to(device)},
                             torch.float32)
    q = w["qa"] if "qa" in w else w["q"]
    return q[i].to(device).float() * w["scale"][i].to(device).float()


def _merge_leaf(w, factor: Dict[str, torch.Tensor], strength: float, requantize: bool = True,
                device: DeviceLike = None):
    """`w` (a [depth, in, out...] stack or a quantized cell) plus strength *
    a @ b, layer by layer in f32 on `device` (w's own by default): a dense
    stack is rounded once to its dtype; a quantized cell is requantized in
    kind (w8a8 back in its input-axis-fastest layout), or with `requantize`
    False returned as the dense f32 merge (the form gradients flow through)."""
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    quantized = isinstance(w, dict)
    first = next(iter(w.values())) if quantized else w
    dev = torch.device(device) if device is not None else first.device
    a, b = factor["a"], factor["b"]
    layers = []
    with _full_f32():
        for i in range(a.shape[0]):
            wf = _dequantized_layer(w, i, dev) if quantized else w[i].to(dev).float()
            delta = (a[i].to(dev, torch.float32) @ b[i].to(dev, torch.float32)) * strength
            merged = wf + delta.reshape(wf.shape)  # qkv: [in, 3, H, hd]
            if not quantized:
                layers.append(merged.to(w.dtype))
            elif requantize:
                layers.append(_requantize_like(w, merged))
            else:
                layers.append(merged)
    if not quantized or not requantize:
        return torch.stack(layers)
    out = {k: torch.stack([c[k] for c in layers]) for k in layers[0]}
    if "qa" in out:
        out["qa"] = _input_axis_fastest(out["qa"])
    return out


def merge_lora(params: Dict[str, Any], lora: Dict[str, Any], strength: float = 1.0,
               requantize: bool = True, device: DeviceLike = None) -> Dict[str, Any]:
    """`params` with strength * (a @ b) added to every weight the adapter
    targets; leaves it does not target are returned by reference. Dense and
    quantized stacks alike ({q | qa, scale}, {q4p, gscale}); with
    `requantize` False a targeted quantized leaf comes back as a dense f32
    merge. The adapter's top-level keys name stacks ("double" / "single",
    or "blocks" for the video DiT); a leaf name may be a dotted path
    ("norm1.lin"). With `device`, every merged leaf is computed and left on
    it (the rest stay where they are)."""
    out = dict(params)
    for stack, factors in lora.items():
        if not factors:
            continue
        if stack not in params:
            raise KeyError(f"LoRA targets unknown stack {stack!r}")
        new_stack = dict(params[stack])
        for leaf, factor in factors.items():
            node = new_stack
            parts = leaf.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"LoRA targets unknown leaf {stack}.{leaf}")
                node[p] = dict(node[p])  # copy-on-write along the path
                node = node[p]
            last = parts[-1]
            if last not in node:
                raise KeyError(f"LoRA targets unknown leaf {stack}.{leaf}")
            node[last] = dict(node[last])
            node[last]["w"] = _merge_leaf(node[last]["w"], factor, strength, requantize, device)
        out[stack] = new_stack
    return out


def merge_loras(params: Dict[str, Any], loras: Sequence[Dict[str, Any]],
                strengths: Optional[Sequence[float]] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Several adapters merged in turn (bf16 weights round after each; int8
    leaves requantize after each)."""
    strengths = strengths or [1.0] * len(loras)
    for lora, s in zip(loras, strengths):
        params = merge_lora(params, lora, s, device=device)
    return params
