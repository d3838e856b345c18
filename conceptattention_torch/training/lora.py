"""LoRA fine-tuning for the Flux DiT: low-rank adapter init and train step.

Counterpart of the JAX package's `training/lora.py`. Only the low-rank
factors train (tens of MB of f32 and their AdamW moments, against 24 GB of
bf16 weights); the base stays frozen, bf16 or quantized, takes no gradient
and has no optimizer state. Standard LoRA init: a ~ N(0, 1/in), b = 0, so
the first step is exactly the base model.

The adapter is its own tree ({"double" | "single": {leaf: {"a" [depth, in,
R], "b" [depth, R, out]}}}, the layout of `weights/lora.py`). The JAX
package merges the whole stack, `merge_lora(base, lora, requantize=False)`,
before the forward. Here each targeted leaf of the base is seen through a
view whose layer i is the merge of layer i alone, computed when the block
takes its parameters: under the loss's rematerialization, inside block i's
checkpointed function, so the backward rebuilds it rather than keeping it.
No merged copy of a stack (23 GB at full width) and no full-size gradient
of one ever exists. Each layer is JAX's sum: (w[i] + s * a[i] @ b[i])
rounded once to w's dtype for a dense leaf, and the dense f32 merge for a
quantized one (rounding to int8 would kill the adapter's gradient at the
cast).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.params import tree_leaves
from conceptattention_torch.ops.quant import w4_dims
from conceptattention_torch.training.train_step import flow_matching_loss
from conceptattention_torch.weights.lora import _dequantized_layer

# Default target set: every big matmul in both block families (the qkv /
# proj / mlp leaves; modulation MLPs excluded by default as is conventional).
DEFAULT_DOUBLE_TARGETS = (
    "img_qkv", "img_proj", "img_mlp_in", "img_mlp_out",
    "txt_qkv", "txt_proj", "txt_mlp_in", "txt_mlp_out",
)
DEFAULT_SINGLE_TARGETS = ("qkv", "proj", "mlp_in", "mlp_out")


def _leaf_dims(w) -> Tuple[int, int, int]:
    """(depth, in, out_flat) of a stacked weight leaf (dense or a quantized
    cell: q / qa keep the weight's shape; the nibble-packed q4p's input size
    comes from quant.w4_dims)."""
    if isinstance(w, dict) and "q4p" in w:
        arr = w["q4p"]
        depth, d_in = arr.shape[0], w4_dims(w)[1]
    else:
        arr = w.get("qa", w.get("q")) if isinstance(w, dict) else w
        depth, d_in = arr.shape[0], arr.shape[1]
    d_out = 1
    for s in arr.shape[2:]:
        d_out *= s
    return depth, d_in, d_out


def init_lora_params(
    generator: torch.Generator,
    params: Dict[str, Any],
    rank: int = 16,
    double_targets: Sequence[str] = DEFAULT_DOUBLE_TARGETS,
    single_targets: Sequence[str] = DEFAULT_SINGLE_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """Zero-effect adapter over the targets the base has (b = 0), on the
    generator's device; a is drawn leaf by leaf in target order, in f32."""
    lora: Dict[str, Any] = {"double": {}, "single": {}}
    dev = generator.device
    for stack, targets in (("double", double_targets), ("single", single_targets)):
        for leaf in targets:
            if leaf not in params[stack]:
                continue
            depth, d_in, d_out = _leaf_dims(params[stack][leaf]["w"])
            a = torch.randn((depth, d_in, rank), generator=generator, device=dev)
            lora[stack][leaf] = {
                "a": (a * d_in**-0.5).to(dtype),
                "b": torch.zeros((depth, rank, d_out), dtype=dtype, device=dev),
            }
    return lora


class _MergedStack:
    """A targeted leaf seen with its adapter: indexing layer i returns that
    layer's merge (`models/flux/params.layer` indexes every leaf of a
    stack), differentiable in the factors."""

    def __init__(self, w, a: torch.Tensor, b: torch.Tensor, strength: float):
        self.w, self.a, self.b, self.strength = w, a, b, strength

    def __getitem__(self, i: int) -> torch.Tensor:
        delta = (self.a[i] @ self.b[i]) * self.strength
        if isinstance(self.w, dict):
            wf = _dequantized_layer(self.w, i, delta.device)
            return wf + delta.reshape(wf.shape)
        w = self.w[i]
        return (w.float() + delta.reshape(w.shape)).to(w.dtype)


def _merged_view(base_params: Dict[str, Any], lora: Dict[str, Any],
                 strength: float = 1.0) -> Dict[str, Any]:
    """`base_params` with every leaf the adapter targets seen through its
    per-layer merge; the rest by reference. For the training forward only:
    the serving path merges once (`weights/lora.merge_lora`)."""
    out = dict(base_params)
    for stack, factors in lora.items():
        if not factors:
            continue
        if stack not in base_params:
            raise KeyError(f"LoRA targets unknown stack {stack!r}")
        new_stack = dict(base_params[stack])
        for leaf, f in factors.items():
            if leaf not in new_stack:
                raise KeyError(f"LoRA targets unknown leaf {stack}.{leaf}")
            new_stack[leaf] = dict(new_stack[leaf],
                                   w=_MergedStack(new_stack[leaf]["w"], f["a"], f["b"], strength))
        out[stack] = new_stack
    return out


def lora_flow_matching_loss(
    lora: Dict[str, Any],
    base_params: Dict[str, Any],
    cfg: FluxConfig,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    strength: float = 1.0,
    *,
    t: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`flow_matching_loss` on the base merged with the adapter, layer by
    layer inside each rematerialized block."""
    return flow_matching_loss(_merged_view(base_params, lora, strength), cfg, batch, generator,
                              t=t, eps=eps)


def make_lora_train_step(cfg: FluxConfig, optimizer: torch.optim.Optimizer,
                         strength: float = 1.0):
    """Build a (lora, base_params, batch, generator, t=None, eps=None) ->
    loss step: gradients of the adapter's factors alone (the tensors
    `optimizer` holds, e.g. from `init_train_state(lora)`), updated in
    place; the loss comes back detached."""

    def step(lora, base_params, batch, generator=None, t=None, eps=None):
        leaves = tree_leaves(lora)
        loss = lora_flow_matching_loss(lora, base_params, cfg, batch, generator, strength,
                                       t=t, eps=eps)
        grads = torch.autograd.grad(loss, leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step


_DOUBLE_NAMES = {
    "img_qkv": "img_attn.qkv", "img_proj": "img_attn.proj", "img_mod": "img_mod.lin",
    "img_mlp_in": "img_mlp.0", "img_mlp_out": "img_mlp.2",
    "txt_qkv": "txt_attn.qkv", "txt_proj": "txt_attn.proj", "txt_mod": "txt_mod.lin",
    "txt_mlp_in": "txt_mlp.0", "txt_mlp_out": "txt_mlp.2",
}
# Single-block leaves export under names the converter takes as they are
# (`weights/lora._single_bfl_plan`), the modulation under its BFL name.
_SINGLE_NAMES = {"mod": "modulation.lin", "qkv": "qkv", "mlp_in": "mlp_in", "proj": "proj",
                 "mlp_out": "mlp_out"}


def export_lora_state_dict(lora: Dict[str, Any],
                           cfg: Optional[FluxConfig] = None) -> Dict[str, torch.Tensor]:
    """Adapter tree -> BFL-tree PEFT-named state dict of CPU f32 tensors
    (`double_blocks.{i}.img_attn.qkv.lora_A.weight` A [r, in],
    `...lora_B.weight` B [out, r], `...alpha` = r), which
    `weights/lora.convert_lora_state_dict` reads back to the same merge."""
    prefix = {"double": "double_blocks", "single": "single_blocks"}
    names = {"double": _DOUBLE_NAMES, "single": _SINGLE_NAMES}
    sd: Dict[str, torch.Tensor] = {}
    for stack in ("double", "single"):
        for leaf, factor in (lora.get(stack) or {}).items():
            a = factor["a"].detach().to("cpu", torch.float32)  # [depth, in, r]
            b = factor["b"].detach().to("cpu", torch.float32)  # [depth, r, out]
            for i in range(a.shape[0]):
                base = f"{prefix[stack]}.{i}.{names[stack][leaf]}"
                sd[f"{base}.lora_A.weight"] = a[i].T.contiguous()
                sd[f"{base}.lora_B.weight"] = b[i].T.contiguous()
                sd[f"{base}.alpha"] = torch.tensor(float(a.shape[-1]))
    return sd
