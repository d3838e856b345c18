"""CLIP text encoder as plain functions on tensors (the pooled vector).

Counterpart of the JAX package's `models/text/clip.py`: the causal text
transformer of `transformers.CLIPTextModel` (learned positions, pre-LN
blocks with quick-GELU, a final LN) pooled at the FIRST end-of-text token,
so its checkpoints convert directly (`convert_clip_text_state_dict`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from conceptattention_torch.models.flux.params import layer, stack_layers


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    max_position_embeddings: int = 77
    eos_token_id: int = 49407


def _ln(x, p, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"] + p["bias"]


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _block(p, cfg: CLIPTextConfig, x, causal_mask):
    h = _ln(x, p["ln1"])
    b, length, d = h.shape
    hd = d // cfg.num_heads
    q, k, v = ((h @ p[n]["w"] + p[n]["b"]).reshape(b, length, cfg.num_heads, hd).transpose(1, 2)
               for n in "qkv")
    logits = (q.float() @ k.float().transpose(-1, -2)) / (hd**0.5) + causal_mask
    attn = (torch.softmax(logits, dim=-1).to(v.dtype) @ v).transpose(1, 2).reshape(b, length, d)
    x = x + attn @ p["o"]["w"] + p["o"]["b"]
    h = _quick_gelu(_ln(x, p["ln2"]) @ p["fc1"]["w"] + p["fc1"]["b"])
    return x + h @ p["fc2"]["w"] + p["fc2"]["b"]


def clip_text_encode(
    params: Dict[str, Any], cfg: CLIPTextConfig, input_ids: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """input_ids [B, L] -> {"last_hidden_state" [B, L, D], "pooler_output"
    [B, D]: the hidden state at each row's first `eos_token_id`}."""
    length = input_ids.shape[1]
    x = params["token_embed"][input_ids] + params["pos_embed"][:length]
    causal = torch.triu(torch.full((length, length), -1e9, device=x.device), diagonal=1)[None, None]
    for i in range(cfg.num_layers):
        x = _block(layer(params["blocks"], i), cfg, x, causal)
    x = _ln(x, params["final_ln"])
    # torch.argmax returns the first of equal maxima: the first EOS
    eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
    return {"last_hidden_state": x, "pooler_output": pooled}


def convert_clip_text_state_dict(sd, cfg: CLIPTextConfig, dtype: torch.dtype = torch.bfloat16,
                                 device=None) -> Dict[str, Any]:
    """HF `CLIPTextModel` state dict (`text_model.*` keys) -> the parameter
    tree on `device` (the state dict's by default)."""
    from conceptattention_torch.weights.convert import StateDict

    s = StateDict(sd, dtype, device)

    def ln(key):
        return {"scale": s(f"{key}.weight"), "bias": s(f"{key}.bias")}

    def block(i):
        p = f"text_model.encoder.layers.{i}"
        proj = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}
        return {
            "ln1": ln(f"{p}.layer_norm1"),
            **{n: s.linear(f"{p}.self_attn.{key}") for n, key in proj.items()},
            "ln2": ln(f"{p}.layer_norm2"),
            "fc1": s.linear(f"{p}.mlp.fc1"),
            "fc2": s.linear(f"{p}.mlp.fc2"),
        }

    return {
        "token_embed": s("text_model.embeddings.token_embedding.weight"),
        "pos_embed": s("text_model.embeddings.position_embedding.weight"),
        "blocks": stack_layers(block, cfg.num_layers),
        "final_ln": ln("text_model.final_layer_norm"),
    }
