"""T5 encoder stack as plain functions on tensors (T5-XXL text conditioning).

Counterpart of the JAX package's `models/text/t5.py`: T5 v1.1's encoder,
pre-RMSNorm blocks, a relative-position-bucket attention bias shared by every
layer, attention without the 1/sqrt(d) scale, a gated FFN with the tanh GELU
and no biases, so HF `T5EncoderModel` checkpoints convert directly
(`convert_t5_state_dict`). The buckets are int32 and their log f32, as in
the JAX package. Attention is a plain matmul and softmax: the JAX package
leaves it to XLA, no kernel takes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from conceptattention_torch.models.flux.params import layer, stack_layers
from conceptattention_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """Bidirectional T5 bucketing: half the buckets for positive offsets,
    exact buckets for small offsets, log-spaced ones up to `max_distance`."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs().to(torch.int32)
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_if_large)


def _attention_bias(p, cfg: T5Config, length: int) -> torch.Tensor:
    """[1, H, L, L] f32 bias of query row i against key column j."""
    pos = torch.arange(length, device=p["rel_bias"].device)
    rel = pos[None, :] - pos[:, None]  # key - query
    buckets = relative_position_bucket(
        rel, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance
    )
    return p["rel_bias"][buckets].permute(2, 0, 1)[None]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _block(p, cfg: T5Config, x, bias, mask):
    h = rms_norm(x, p["ln1"])
    b, length, _ = h.shape
    q, k, v = ((h @ p[n]).reshape(b, length, cfg.num_heads, cfg.d_kv).transpose(1, 2)
               for n in "qkv")
    logits = q.float() @ k.float().transpose(-1, -2) + bias + mask
    attn = torch.softmax(logits, dim=-1).to(v.dtype) @ v
    x = x + attn.transpose(1, 2).reshape(b, length, -1) @ p["o"]
    h = rms_norm(x, p["ln2"])
    return x + (_gelu(h @ p["wi0"]) * (h @ p["wi1"])) @ p["wo"]


def t5_encode(
    params: Dict[str, Any],
    cfg: T5Config,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """input_ids [B, L] -> last hidden state [B, L, d_model] in the
    parameters' dtype; masked keys (attention_mask 0) get -1e9."""
    x = params["embed"][input_ids]
    length = input_ids.shape[1]
    bias = _attention_bias(params, cfg, length)
    if attention_mask is None:
        mask = torch.zeros((1, 1, 1, length), dtype=torch.float32, device=x.device)
    else:
        mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
    for i in range(cfg.num_layers):
        x = _block(layer(params["blocks"], i), cfg, x, bias, mask)
    return rms_norm(x, params["final_ln"])


def init_t5_params(generator: torch.Generator, cfg: T5Config,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random T5 parameters on the generator's device, with the JAX
    package's distributions: N(0, 1/fan_in) matrices (q: 1/(d_model*d_kv)),
    N(0, 1) embeddings, N(0, 0.01) f32 bias buckets, unit norm scales."""
    dev = generator.device

    def mat(a, b, scale=None):
        x = torch.randn((a, b), generator=generator, device=dev)
        return (x * (scale or a**-0.5)).to(dtype)

    inner = cfg.num_heads * cfg.d_kv

    def block(_):
        return {
            "ln1": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "q": mat(cfg.d_model, inner, scale=(cfg.d_model * cfg.d_kv) ** -0.5),
            "k": mat(cfg.d_model, inner),
            "v": mat(cfg.d_model, inner),
            "o": mat(inner, cfg.d_model),
            "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "wi0": mat(cfg.d_model, cfg.d_ff),
            "wi1": mat(cfg.d_model, cfg.d_ff),
            "wo": mat(cfg.d_ff, cfg.d_model),
        }

    return {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                             device=dev).to(dtype),
        "rel_bias": 0.1 * torch.randn((cfg.relative_attention_num_buckets, cfg.num_heads),
                                      generator=generator, device=dev),
        "blocks": stack_layers(block, cfg.num_layers),
        "final_ln": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


def convert_t5_state_dict(sd, cfg: T5Config, dtype: torch.dtype = torch.bfloat16,
                          device=None) -> Dict[str, Any]:
    """HF `T5EncoderModel` state dict -> the parameter tree on `device` (the
    state dict's by default); the bias buckets stay f32."""
    from conceptattention_torch.weights.convert import StateDict

    s = StateDict(sd, dtype, device)

    def block(i):
        p = f"encoder.block.{i}"
        attn, ff = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        return {
            "ln1": s(f"{p}.layer.0.layer_norm.weight"),
            **{n: s(f"{attn}.{n}.weight", transpose=True) for n in "qkvo"},
            "ln2": s(f"{p}.layer.1.layer_norm.weight"),
            "wi0": s(f"{ff}.wi_0.weight", transpose=True),
            "wi1": s(f"{ff}.wi_1.weight", transpose=True),
            "wo": s(f"{ff}.wo.weight", transpose=True),
        }

    return {
        "embed": s("shared.weight"),
        "rel_bias": s("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                      dtype=torch.float32),
        "blocks": stack_layers(block, cfg.num_layers),
        "final_ln": s("encoder.final_layer_norm.weight"),
    }
