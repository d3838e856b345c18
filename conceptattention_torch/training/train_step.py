"""Rectified-flow (flow-matching) training step for the Flux DiT.

Counterpart of the JAX package's `training/train_step.py`. The same
`flux_forward` runs under autograd with the conditional flow-matching
objective

    x_t = t * eps + (1 - t) * x_data,    v* = eps - x_data,
    L = E_t ||v_theta(x_t, t) - v*||^2

(the probability path of the Euler sampler: x_{t-dt} = x_t - dt * v), with
each block rematerialized in the backward (`remat=True`). The forward runs
on the plain, differentiable attention (`backend="sdpa"`, the JAX package's
default "xla" backend): the kernels have no backward and refuse autograd.
The optimizer is `torch.optim.AdamW` with weight decay 0, as JAX passes to
optax.adamw; it updates the parameter tensors in place, so a step returns
only the loss.

On a mesh (`parallel.fsdp.shard_params_fsdp`, `parallel.sharding.
shard_params`) the parameters are `Sharded` leaves and the optimizer holds
their pieces, so AdamW's moments live in the parameters' layout. The
forward runs over the mesh (`flux_forward`): each data rank its rows of the
batch against layers gathered one at a time inside the rematerialized
block, tensor-parallel over `model`; the backward returns each gradient to
the piece it came from, summed over the ranks that used it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.dit import flux_forward
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.parallel.collectives import NamedSharding, Sharded
from conceptattention_torch.parallel.mesh import AXES
from conceptattention_torch.parallel.sharding import (
    replica_groups,
    sharded_pieces,
    sum_replica_grads,
    tree_mesh,
)

# The plain attention for the double and the single blocks alike
# (`flux_forward` passes spec.backend to the single blocks).
TRAIN_SPEC = ConceptAttentionSpec(backend="sdpa")


def check_layout(params, mesh, param_sharding=None, batch_sharding=None) -> None:
    """Raise unless `params` are laid out over `mesh` as `param_sharding`
    says and `batch_sharding` splits the batch over `data` (or nothing):
    the step takes its layout from the parameter tree, as JAX's jit takes
    it from the shardings."""
    if mesh is None:
        if param_sharding is not None or batch_sharding is not None:
            raise ValueError("param_sharding / batch_sharding need a mesh")
        return
    if tree_mesh(params) is not mesh:
        raise ValueError("the parameters must be laid out over `mesh` "
                         "(parallel.fsdp.shard_params_fsdp or parallel.sharding.shard_params)")

    def same(p, s):
        if isinstance(s, dict):
            for k in s:
                same(p[k], s[k])
        elif isinstance(s, NamedSharding) and isinstance(p, Sharded):
            want = tuple(s.spec) + (None,) * (p.dim() - len(s.spec))
            if p.spec != want:
                raise ValueError(f"a parameter is laid out as {p.spec}, param_sharding says {want}")

    if param_sharding is not None:
        same(params, param_sharding)
    for s in ([batch_sharding] if isinstance(batch_sharding, NamedSharding)
              else list((batch_sharding or {}).values())):
        if tuple(s.spec)[:1] not in ((), (None,), (AXES.data,)) or any(tuple(s.spec)[1:]):
            raise ValueError(f"the batch splits over {AXES.data!r} on its leading dimension, "
                             f"not {s.spec}")


def trainable_leaves(params) -> list:
    """The tensors an optimizer holds: the leaves of a plain tree, the
    distinct pieces of a `Sharded` one."""
    return sharded_pieces(params)


def flow_matching_loss(
    params: Dict[str, Any],
    cfg: FluxConfig,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    t: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Conditional flow-matching MSE (f32) on packed latents.

    batch: {img [B, P, C], img_ids, txt, txt_ids, y} (+ guidance), in the
    parameters' dtype and on their device. t [B] is drawn logit-normal
    (sigmoid of a standard normal, SD3-style) and eps [B, P, C] standard
    normal, both f32 from `generator`, t first; a caller may pass either.
    """
    x = batch["img"].float()
    if t is None:
        t = torch.sigmoid(torch.randn(x.shape[0], generator=generator, device=x.device))
    if eps is None:
        eps = torch.randn(x.shape, generator=generator, device=x.device)
    t_b = t[:, None, None]
    x_t = t_b * eps + (1.0 - t_b) * x
    target = eps - x
    pred, _ = flux_forward(
        params, cfg,
        img=x_t.to(batch["img"].dtype), img_ids=batch["img_ids"],
        txt=batch["txt"], txt_ids=batch["txt_ids"],
        timesteps=t, y=batch["y"], guidance=batch.get("guidance"),
        spec=TRAIN_SPEC,
        remat=True,  # the backward recomputes each block from its inputs
    )
    return torch.mean(torch.square(pred.float() - target))


def init_train_state(params: Dict[str, Any], learning_rate: float = 1e-4,
                     weight_decay: float = 0.0) -> torch.optim.AdamW:
    """Mark every leaf of `params` (every piece of a sharded tree) trainable
    and return AdamW over them. The optimizer holds its state (torch's form
    of JAX's (tx, opt_state)), in the parameters' layout."""
    leaves = [x.requires_grad_(True) for x in trainable_leaves(params)]
    return torch.optim.AdamW(leaves, lr=learning_rate, weight_decay=weight_decay)


def make_train_step(
    cfg: FluxConfig,
    optimizer: torch.optim.Optimizer,
    mesh=None,
    param_sharding=None,
    batch_sharding=None,
):
    """Build a (params, batch, generator, t=None, eps=None) -> loss step
    that updates `params` (the tensors `optimizer` holds) in place and
    returns the loss, detached. With `mesh`, the parameters must be laid out
    over it (as `param_sharding` says, when given) and the batch splits over
    its `data` axis (`batch_sharding` P("data")); the draws t and eps are
    made for the whole batch, so the step equals the one-device step."""

    def step(params, batch, generator=None, t=None, eps=None):
        check_layout(params, mesh, param_sharding, batch_sharding)
        optimizer.zero_grad(set_to_none=True)
        loss = flow_matching_loss(params, cfg, batch, generator, t=t, eps=eps)
        loss.backward()
        if mesh is not None:
            _sum_replica_grads(params)
        optimizer.step()
        return loss.detach()

    return step


def _sum_replica_grads(params) -> None:
    """Copies of one piece on different devices take the sum of their
    gradients (the all-reduce of a replicated parameter)."""
    groups = replica_groups(params)
    if not groups:
        return
    grads = {id(t): t.grad if t.grad is not None else torch.zeros_like(t)
             for copies in groups for t in copies}
    sum_replica_grads(groups, grads)
    for copies in groups:
        for t in copies:
            t.grad = grads[id(t)]
