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
only the loss. Mesh and sharding arguments are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.dit import flux_forward
from conceptattention_torch.models.flux.params import tree_leaves
from conceptattention_torch.ops.attention import ConceptAttentionSpec

# The plain attention for the double and the single blocks alike
# (`flux_forward` passes spec.backend to the single blocks).
TRAIN_SPEC = ConceptAttentionSpec(backend="sdpa")


def refuse_mesh(mesh, *shardings) -> None:
    """Raise for a mesh or sharding argument: the port trains on one device."""
    if mesh is not None or any(s is not None for s in shardings):
        raise NotImplementedError(
            "mesh and sharding arguments are not ported: the data- and tensor-parallel "
            "training layout is ROADMAP Queue 1 item 8"
        )


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
    """Mark every leaf of `params` trainable and return AdamW over them. The
    optimizer holds its state (torch's form of JAX's (tx, opt_state))."""
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
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
    returns the loss, detached."""
    refuse_mesh(mesh, param_sharding, batch_sharding)

    def step(params, batch, generator=None, t=None, eps=None):
        optimizer.zero_grad(set_to_none=True)
        loss = flow_matching_loss(params, cfg, batch, generator, t=t, eps=eps)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
