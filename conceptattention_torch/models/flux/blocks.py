"""Flux DiT block bodies as plain functions on tensors.

Counterpart of the JAX package's `models/flux/blocks.py`. Linear weights are dense or quantized cells of `ops/quant.py`:
w8 and w4 weights are expanded to the activation dtype for the product, w8a8
runs an exact int8 x int8 -> int32 product. The concept stream is an optional input of the double
block: concepts reuse the txt weights with their own modulation vector,
concept queries attend over [concept; img] keys with their own softmax
denominator, concepts get their own residual and MLP update, and the image
and text streams are computed exactly as if concepts were absent. Saliency
taps are emitted as reduced [B, C, P] f32 concept-by-patch maps, or, in the
raw-vector mode, as the vector sets they are computed from.

Each block's body is a generator (`_double_body`, `_single_body`) that
yields a collective wherever tensor parallelism sums over ranks; the dense
block drives it as one rank, which never yields, and `tp_axis` runs it once
per rank through `parallel.collectives.shard_map`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.kernels.flash_saliency import (
    expand_rope_tables,
    fused_concept_flash_attention,
)
from conceptattention_torch.ops.attention import (
    RING_BACKENDS,
    ConceptAttentionSpec,
    joint_concept_attention,
    merge_heads,
    sdpa,
    similarity_map_heads,
)
from conceptattention_torch.ops.norms import layer_norm, modulation, rms_norm
from conceptattention_torch.ops.quant import (
    dequantize_w4,
    int8_matmul,
    quantize_activations_per_token,
)
from conceptattention_torch.ops.rope import apply_rope
from conceptattention_torch.parallel.collectives import drive, lax, shard_map
from conceptattention_torch.parallel.sharding import restrict_tree, tree_mesh


def _int8_product(x: torch.Tensor, qa: torch.Tensor) -> torch.Tensor:
    """x @ qa for an int8 weight [D, out...] with x quantized per token:
    (int32 product * token scale) rounded to x's dtype, [..., prod(out)]."""
    xq, xs = quantize_activations_per_token(x)
    y32 = int8_matmul(xq, qa.reshape(qa.shape[0], -1))
    return (y32.float() * xs).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a dense weight. Operands of two dtypes are both cast to
    `torch.promote_types` of the pair, as JAX promotes bf16 @ f32 to f32:
    the training form of a LoRA over a quantized base is a dense f32 merge
    (`weights/lora.merge_lora(..., requantize=False)`) met by bf16
    activations."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def _linear(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """x @ w + b with w dense or a quantized cell: {"qa", "scale"} (w8a8,
    both scales fold into the output), {"q4p", "gscale"} (w4, dequantized)
    or {"q", "scale"} (w8, the scale folds into the output)."""
    w = p["w"]
    if isinstance(w, dict) and "qa" in w:
        y = _int8_product(x, w["qa"]) * w["scale"][0]
    elif isinstance(w, dict) and "q4p" in w:
        y = x @ dequantize_w4(w, x.dtype)
    elif isinstance(w, dict):
        y = (x @ w["q"].to(x.dtype)) * w["scale"][0]
    else:
        y = _dense(x, w)
    if "b" in p:
        y = y + p["b"]
    return y


def _qkv_heads(x_mod, qkv_p, qnorm, knorm, num_heads: int):
    """Fused [D, 3, H, head_dim] projection (dense or quantized) ->
    QK-normalized per-head (q, k, v), each [B, H, L, head_dim]. Quantized
    products are rounded to the activation dtype before the weight scale."""
    w = qkv_p["w"]
    if isinstance(w, dict) and "qa" in w:
        qkv = _int8_product(x_mod, w["qa"]) * w["scale"][0].reshape(-1)
    elif isinstance(w, dict) and "q4p" in w:
        wd = dequantize_w4(w, x_mod.dtype)
        qkv = x_mod @ wd.reshape(wd.shape[0], -1)
    elif isinstance(w, dict):
        q = w["q"]
        qkv = (x_mod @ q.reshape(q.shape[0], -1).to(x_mod.dtype)) * w["scale"][0].reshape(-1)
    else:
        qkv = _dense(x_mod, w.reshape(w.shape[0], -1))
    if "b" in qkv_p:
        qkv = qkv + qkv_p["b"].reshape(-1)
    b, l, _ = qkv.shape
    q, k, v = qkv.reshape(b, l, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    q = rms_norm(q, qnorm).to(v.dtype)
    k = rms_norm(k, knorm).to(v.dtype)
    return q, k, v


def _mlp(x, p_in, p_out):
    return _linear(F.gelu(_linear(x, p_in), approximate="tanh"), p_out)


def _row_linear(x, p: Dict[str, Any], tp_axis: Optional[str]):
    """x @ w + b for a row-parallel weight (a generator body step): under
    `tp_axis` w's INPUT axis is sharded over that axis, each rank's partial
    product is summed over the ranks, and the bias is added once, after the
    sum. The sums run on the product before any output scale: exact int32
    for w8a8, whose per-token activation scale is taken from the absmax of
    the WHOLE row (the max over the ranks), so the result is the dense
    function's; f32 for the rest. Without `tp_axis` this is `_linear`."""
    if tp_axis is None:
        return _linear(x, p)
    w = p["w"]
    if isinstance(w, dict) and "qa" in w:
        amax = yield lax.pmax(x.float().abs().amax(dim=-1, keepdim=True), tp_axis)
        xq, xs = quantize_activations_per_token(x, amax=amax)
        qa = w["qa"]
        y32 = yield lax.psum(int8_matmul(xq, qa.reshape(qa.shape[0], -1)), tp_axis)
        y = (y32.float() * xs).to(x.dtype) * w["scale"][0]
    elif isinstance(w, dict) and "q4p" in w:
        y = yield lax.psum((x @ dequantize_w4(w, x.dtype)).float(), tp_axis)
        y = y.to(x.dtype)
    elif isinstance(w, dict):
        y = yield lax.psum((x @ w["q"].to(x.dtype)).float(), tp_axis)
        y = y.to(x.dtype) * w["scale"][0]
    else:
        part = _dense(x, w)
        y = (yield lax.psum(part.float(), tp_axis)).to(part.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def _mlp_body(x, p_in, p_out, tp_axis: Optional[str]):
    """Column-parallel in (local hidden units and their bias), row-parallel
    out: the Megatron MLP under `tp_axis`."""
    return (yield from _row_linear(F.gelu(_linear(x, p_in), approximate="tanh"), p_out, tp_axis))


def _tp_call(body, p, tp_axis: str, num_heads: int, spec: ConceptAttentionSpec, *args):
    """Run `body(p_local, heads_local, spec_local, *args)` once for each rank
    along `tp_axis` of the mesh that `p`'s `Sharded` leaves live on (every
    other axis at its first index): the per-rank shards of p, the local
    head count, and for a ring backend a spec whose mesh is the rank's own
    slice of p's mesh (its seq ring at its model index). The replicated
    outputs come back on the first rank's device."""
    mesh = tree_mesh(p)
    if mesh is None:
        raise ValueError(f"tp_axis={tp_axis!r} needs a parameter tree laid out over a mesh "
                         "(parallel.sharding.shard_params / place_tree)")
    n = mesh.shape[tp_axis]
    if num_heads % n:
        raise ValueError(f"{num_heads} heads do not divide over {tp_axis}={n}")
    others = {a: 0 for a in mesh.axis_names if a != tp_axis}
    p_tp = restrict_tree(p, **others)

    def rank_body(rank, p_local, *local_args):
        rspec = spec
        if spec.backend in RING_BACKENDS:
            rspec = dataclasses.replace(spec, mesh=mesh.sub(**{tp_axis: rank.index(tp_axis)}),
                                        batch_axis=None, head_axis=None)
        return (yield from body(p_local, num_heads // n, rspec, *local_args))

    return shard_map(rank_body, mesh.sub(**others), (None,) * (1 + len(args)), None)(p_tp, *args)


def double_block(
    p: Dict[str, Any],
    img: torch.Tensor,
    txt: torch.Tensor,
    vec: torch.Tensor,
    pe: Tuple[torch.Tensor, torch.Tensor],
    num_heads: int,
    concepts: Optional[torch.Tensor] = None,
    concept_vec: Optional[torch.Tensor] = None,
    concept_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
    tp_axis: Optional[str] = None,
):
    """One double-stream block. Returns (img, txt, concepts, saliency), where
    saliency maps tap names to [B, C, P] f32 maps, empty without concepts.
    With `spec.return_raw_vectors` it holds the block's vector sets instead:
    `output_space_{concept,image}_vectors`, the merged-head attention
    outputs [B, L, H*D], and `cross_attention_{concept,image}_vectors`, the
    pre-RoPE q in head form [B, H, L, D].

    tp_axis: Megatron tensor parallelism over that axis of the mesh that
    p's `Sharded` leaves live on: each rank projects its heads (qkv) and
    hidden units (mlp_in), attends over its heads (one kernel launch per
    rank on the fused backend), and the ranks' partial products of the
    row-parallel proj / mlp_out are summed before the one bias, as are the
    head sums of the saliency maps. The result equals the dense block."""
    if tp_axis is not None:
        if spec.return_raw_vectors:
            raise ValueError(
                "return_raw_vectors emits merged-head vectors, which are "
                "partial-width under tensor parallelism; use the reduced taps"
            )
        return _tp_call(_double_body, p, tp_axis, num_heads, spec, img, txt, vec, pe,
                        concepts, concept_vec, concept_pe, tp_axis)
    return drive(_double_body(p, num_heads, spec, img, txt, vec, pe, concepts, concept_vec,
                              concept_pe, None))


def _double_body(p, num_heads, spec, img, txt, vec, pe, concepts, concept_vec, concept_pe,
                 tp_axis):
    """The double block as a rank body (a generator): num_heads is the
    rank's own, and every sum over the ranks is a yielded collective."""
    img_mod1, img_mod2 = modulation(vec, p["img_mod"]["w"], p["img_mod"]["b"], double=True)
    txt_mod1, txt_mod2 = modulation(vec, p["txt_mod"]["w"], p["txt_mod"]["b"], double=True)

    img_modulated = (1 + img_mod1.scale) * layer_norm(img) + img_mod1.shift
    img_qkv = _qkv_heads(img_modulated, p["img_qkv"], p["img_qnorm"], p["img_knorm"], num_heads)
    txt_modulated = (1 + txt_mod1.scale) * layer_norm(txt) + txt_mod1.shift
    txt_qkv = _qkv_heads(txt_modulated, p["txt_qkv"], p["txt_qnorm"], p["txt_knorm"], num_heads)

    concept_qkv = None
    if concepts is not None:
        con_mod1, con_mod2 = modulation(
            concept_vec, p["txt_mod"]["w"], p["txt_mod"]["b"], double=True
        )
        con_modulated = (1 + con_mod1.scale) * layer_norm(concepts) + con_mod1.shift
        concept_qkv = _qkv_heads(
            con_modulated, p["txt_qkv"], p["txt_qnorm"], p["txt_knorm"], num_heads
        )

    txt_attn, img_attn, concept_attn, extras = joint_concept_attention(
        txt_qkv, img_qkv, concept_qkv, pe, concept_pe, spec
    )

    saliency: Dict[str, torch.Tensor] = {}
    if concepts is not None and spec.return_raw_vectors:
        saliency = {
            "output_space_concept_vectors": concept_attn,
            "output_space_image_vectors": img_attn,
            "cross_attention_concept_vectors": extras["concept_q"],
            "cross_attention_image_vectors": extras["img_q"],
        }
    elif concepts is not None:
        pairs = {
            "output": ("concept_out_h", "img_out_h"),
            "cross_attention": ("concept_q", "img_q"),
            "value": ("concept_v", "img_v"),
        }
        for tap in spec.taps:
            con, im = pairs[tap]
            saliency[tap] = similarity_map_heads(extras[con], extras[im])
        if tp_axis is not None:  # the head sum ran over this rank's heads
            saliency = yield lax.psum(saliency, tp_axis)

    img = img + img_mod1.gate * (yield from _row_linear(img_attn, p["img_proj"], tp_axis))
    img = img + img_mod2.gate * (yield from _mlp_body(
        (1 + img_mod2.scale) * layer_norm(img) + img_mod2.shift,
        p["img_mlp_in"], p["img_mlp_out"], tp_axis,
    ))
    txt = txt + txt_mod1.gate * (yield from _row_linear(txt_attn, p["txt_proj"], tp_axis))
    txt = txt + txt_mod2.gate * (yield from _mlp_body(
        (1 + txt_mod2.scale) * layer_norm(txt) + txt_mod2.shift,
        p["txt_mlp_in"], p["txt_mlp_out"], tp_axis,
    ))
    if concepts is not None:
        concepts = concepts + con_mod1.gate * (
            yield from _row_linear(concept_attn, p["txt_proj"], tp_axis))
        concepts = concepts + con_mod2.gate * (yield from _mlp_body(
            (1 + con_mod2.scale) * layer_norm(concepts) + con_mod2.shift,
            p["txt_mlp_in"], p["txt_mlp_out"], tp_axis,
        ))
    return img, txt, concepts, saliency


def single_block(
    p: Dict[str, Any],
    x: torch.Tensor,
    vec: torch.Tensor,
    pe: Tuple[torch.Tensor, torch.Tensor],
    num_heads: int,
    mlp_hidden_dim: int,
    backend: str = "fused",
    int8_qk: bool = False,
    tp_axis: Optional[str] = None,
) -> torch.Tensor:
    """Single-stream block (parallel attention + MLP). backend "fused" runs
    the self-attention through one flash-saliency kernel launch with RoPE in
    the kernel (int8 q/k scores with `int8_qk`); "sdpa" is the plain
    reference path, which has no int8 scores. The ring backends take the
    plain path too: the JAX package runs these blocks through XLA's dense
    SDPA under a ring spec.

    tp_axis: tensor parallelism as in `double_block` (the JAX package gets
    it from GSPMD and `sharding._single_block_spec`): qkv and mlp_in by
    heads and hidden units, one attention launch per rank on its heads,
    proj and mlp_out summed over the ranks before the bias."""
    if int8_qk and backend != "fused":
        raise ValueError(f"int8_qk requires the fused attention backend, got {backend!r}")
    spec = ConceptAttentionSpec(backend=backend, int8_qk=int8_qk)
    if tp_axis is not None:
        return _tp_call(_single_body, p, tp_axis, num_heads, spec, x, vec, pe, tp_axis)
    return drive(_single_body(p, num_heads, spec, x, vec, pe, None))


def _single_body(p, num_heads, spec, x, vec, pe, tp_axis):
    mod, _ = modulation(vec, p["mod"]["w"], p["mod"]["b"], double=False)
    x_mod = (1 + mod.scale) * layer_norm(x) + mod.shift
    q, k, v = _qkv_heads(x_mod, p["qkv"], p["qnorm"], p["knorm"], num_heads)
    mlp = _linear(x_mod, p["mlp_in"])
    if spec.backend == "fused":
        l = q.shape[2]
        rope_cos, rope_sin = expand_rope_tables([pe], l)
        out = fused_concept_flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            txt_len=l, img_len=0, concept_len=0, rope_cos=rope_cos, rope_sin=rope_sin,
            int8_qk=spec.int8_qk,
        )
        attn = merge_heads(out)
    elif spec.backend == "sdpa" or spec.backend in RING_BACKENDS:
        q, k = apply_rope(q, k, pe)
        attn = merge_heads(sdpa(q, k, v))
    else:
        raise ValueError(f"unknown attention backend {spec.backend!r}")
    # linear2(concat([attn, gelu(mlp)])) == attn @ W_proj + gelu(mlp) @ W_mlp_out + b
    out = (yield from _row_linear(attn, p["proj"], tp_axis)) + (
        yield from _row_linear(F.gelu(mlp, approximate="tanh"), p["mlp_out"], tp_axis))
    return x + mod.gate * out


def last_layer(p: Dict[str, Any], x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Final AdaLN + projection."""
    mod = F.silu(vec) @ p["adaln"]["w"] + p["adaln"]["b"]
    shift, scale = mod.chunk(2, dim=-1)
    x = (1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :]
    return _linear(x, p["linear"])
