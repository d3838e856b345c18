"""Expert parallelism (ep): a mixture-of-experts MLP with all-to-all dispatch.

Counterpart of the JAX package's `parallel/moe.py`, the GShard / Switch
token-choice scheme:

  - top-k routing with renormalized gate weights and a static per-expert
    capacity (dense one-hot dispatch / combine einsums: static shapes, no
    scatter, no sort);
  - over the `expert` mesh axis, tokens are sharded with the experts: each
    rank computes its tokens' dispatch tensor, one all-to-all ships the
    expert-major token blocks to the ranks that own those experts, the
    local experts run as one batched matmul, and a second all-to-all ships
    the results back for the local combine (both through
    `parallel.collectives`, as a generator body's yields);
  - capacity is the drop control: `capacity >= top_k * n_local_tokens`
    guarantees no drops, and then the ep result equals the dense
    reference;
  - the Switch load-balancing loss (E * sum_e f_e * p_e) from the same
    gating tensors, its statistics averaged over the ranks before the
    product.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.parallel.collectives import P, lax, shard_map


def init_moe_params(
    generator: torch.Generator,
    d_model: int,
    d_hidden: int,
    num_experts: int,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """Router + per-expert MLP parameters, experts stacked on axis 0, drawn
    N(0, 1/fan_in) in f32 from `generator` on its device, then cast."""
    def normal(*shape, fan_in):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x / fan_in**0.5).to(dtype)

    return {
        "router": normal(d_model, num_experts, fan_in=d_model),
        "w_in": normal(num_experts, d_model, d_hidden, fan_in=d_model),
        "w_out": normal(num_experts, d_hidden, d_model, fan_in=d_hidden),
    }


def _one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def _route(gates: torch.Tensor, top_k: int, capacity: int):
    """Dispatch / combine tensors of token-choice top-k routing.

    gates: [n, E] router probabilities. Returns (dispatch [n, E, C] {0, 1},
    combine [n, E, C] gate-weighted, frac [E] first-choice fractions,
    gate_mean [E] mean probabilities); aux = E * sum(frac * gate_mean),
    assembled by the caller so the ep path averages the statistics over the
    ranks first. Capacity slots are claimed in (choice rank, token) order:
    all first choices, then all second choices (a token's primary expert is
    dropped last)."""
    n, num_experts = gates.shape
    topv, topi = torch.topk(gates, top_k, dim=-1, sorted=True)  # [n, k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    onehot = _one_hot(topi, num_experts, gates.dtype)  # [n, k, E]
    flat = onehot.transpose(0, 1).reshape(top_k * n, num_experts)
    pos = torch.cumsum(flat, dim=0) - flat  # position within each expert
    keep = (pos < capacity).to(gates.dtype) * flat
    slot = (pos * flat).sum(-1).to(torch.int64)  # [k*n]
    slot_oh = _one_hot(slot, capacity, gates.dtype)  # [k*n, C]

    keep = keep.reshape(top_k, n, num_experts)
    slot_oh = slot_oh.reshape(top_k, n, capacity)
    dispatch = torch.einsum("kne,knc->nec", keep, slot_oh)
    combine = torch.einsum("kn,kne,knc->nec", topv.transpose(0, 1), keep, slot_oh)

    frac = onehot[:, 0, :].mean(0)
    gate_mean = gates.mean(0)
    return dispatch, combine, frac, gate_mean


def _expert_mlp(w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Every expert's MLP on its [E, C, d] block: one batched matmul each way."""
    return torch.bmm(F.gelu(torch.bmm(x, w_in), approximate="tanh"), w_out)


def _default_capacity(n: int, top_k: int, num_experts: int) -> int:
    # capacity_factor 1.25 over the balanced load, floor of 4.
    return max(4, int(1.25 * top_k * n / num_experts))


def moe_mlp(
    params: Dict[str, Any],
    x: torch.Tensor,
    top_k: int = 2,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device dense reference: [n, d] tokens -> ([n, d], aux_loss)."""
    n = x.shape[0]
    num_experts = params["router"].shape[1]
    if capacity is None:
        capacity = _default_capacity(n, top_k, num_experts)
    gates = torch.softmax((x @ params["router"]).float(), dim=-1)
    dispatch, combine, frac, gate_mean = _route(gates, top_k, capacity)
    staged = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), x)
    y = _expert_mlp(params["w_in"], params["w_out"], staged)
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), y)
    aux = num_experts * torch.sum(frac * gate_mean)
    return out, aux


def moe_mlp_expert_parallel(
    params: Dict[str, Any],
    x: torch.Tensor,
    mesh,
    axis: str = "expert",
    top_k: int = 2,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: tokens AND experts sharded over `axis` (one rank
    per index of it; every other axis at its first index).

    `x` is [n, d] global tokens (n divisible by the ep group size); the
    expert stacks split over the ranks; two all-to-alls move the routed
    token blocks to and from the owning ranks. With `capacity >= top_k *
    n_local` this equals `moe_mlp` (no drops). Returns ([n, d], aux_loss) on
    the mesh's first device.
    """
    ep = mesh.shape[axis]
    n = x.shape[0]
    num_experts = params["router"].shape[1]
    if n % ep != 0:
        raise ValueError(f"{n} tokens not divisible by {ep} ep devices")
    if num_experts % ep != 0:
        raise ValueError(f"{num_experts} experts not divisible by ep={ep}")
    cap = _default_capacity(n // ep, top_k, num_experts) if capacity is None else capacity

    def body(rank, router, w_in, w_out, x_loc):
        gates = torch.softmax((x_loc @ router).float(), dim=-1)
        dispatch, combine, frac, gate_mean = _route(gates, top_k, cap)
        # [E, C, d] expert-major token blocks of this rank's tokens
        staged = torch.einsum("nec,nd->ecd", dispatch.to(x_loc.dtype), x_loc)
        # each expert block to its owner: [E/ep, C*ep, d] for this rank's experts
        staged = yield lax.all_to_all(staged, axis, 0, 1)
        y = _expert_mlp(w_in, w_out, staged)
        # the results back to the tokens' ranks: [E, C, d]
        y = yield lax.all_to_all(y, axis, 1, 0)
        out = torch.einsum("nec,ecd->nd", combine.to(x_loc.dtype), y)
        # the global Switch loss: statistics averaged over the ranks (equal
        # token shards, so the mean of means) before their product
        frac_g = yield lax.pmean(frac, axis)
        gate_mean_g = yield lax.pmean(gate_mean, axis)
        return out, num_experts * torch.sum(frac_g * gate_mean_g)

    others = {a: 0 for a in mesh.axis_names if a != axis}
    return shard_map(body, mesh.sub(**others), (None, P(axis), P(axis), P(axis)),
                     (P(axis), None))(params["router"], params["w_in"], params["w_out"], x)
