"""Training loop around `training/train_step.py`.

Counterpart of the JAX package's `training/train_loop.py`, which chains
optax transforms; this module computes what that chain computes:

  - linear warmup, then cosine decay to `min_lr_ratio` x peak
    (`optax.warmup_cosine_decay_schedule`, in f32 as optax evaluates it);
  - clipping by the global norm (`optax.clip_by_global_norm`: g unchanged
    below `max_norm`, else (g / |g|) * max_norm), then AdamW
    (`torch.optim.AdamW`, weight decay `weight_decay`);
  - with `grad_accum` k > 1, `optax.MultiSteps`: a running mean of the
    micro-step gradients, acc + (g - acc) / (n + 1); the parameters move,
    and the schedule's count advances, only on every k-th micro-step;
  - an EMA shadow updated on every micro-step, the mini-steps included, as
    the JAX step does;
  - checkpoints of {params, ema, opt_state} (`utils/checkpoint.py`) every
    `checkpoint_every` micro-steps, with resume from the latest: the
    parameters, the EMA and the whole optimizer state (AdamW's moments and
    step, the schedule's count, the accumulator and its mini-step) restore,
    the data stream is advanced past the consumed batches, and each step's
    generator is seeded from (seed, step index), the counterpart of
    `fold_in(key, i)`, so a resumed run draws what an uninterrupted one
    would.

On a mesh the parameters and the EMA are `Sharded` trees
(`parallel.fsdp.shard_params_fsdp`): the optimizer, its accumulator and
the checkpoints hold their pieces, in the layout (`train_step.py`).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.params import tree_leaves, tree_map
from conceptattention_torch.parallel.collectives import Sharded
from conceptattention_torch.parallel.sharding import replica_groups, sum_replica_grads, tree_mesh
from conceptattention_torch.training.train_step import (
    check_layout,
    flow_matching_loss,
    trainable_leaves,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 100
    min_lr_ratio: float = 0.1      # cosine floor as a fraction of peak
    max_grad_norm: float = 1.0
    grad_accum: int = 1            # microbatches per optimizer update
    ema_decay: float = 0.999       # 0 disables the EMA shadow
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100    # MICRO-steps between saves
    log_every: int = 10


@functools.lru_cache(maxsize=None)
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """count (optimizer updates so far) -> learning rate: linear warmup from
    0 to the peak, then cosine decay to `min_lr_ratio` x peak.

    Built in optimizer-update units, as the JAX package builds it for
    optax.MultiSteps: warmup_steps // k updates of warmup and
    max(total_steps // k, warmup + 1) in all. Evaluated as
    `optax.warmup_cosine_decay_schedule` evaluates it, in f32 in its order
    of operations, with the C library's `cosf` (what XLA's CPU backend
    calls), so the values are optax's own; a warmup of 0 starts at the peak.
    """
    f32 = np.float32
    k = max(1, tc.grad_accum)
    warmup = max(0, tc.warmup_steps // k)
    total = max(tc.total_steps // k, warmup + 1)
    peak = tc.learning_rate
    end = tc.learning_rate * tc.min_lr_ratio
    alpha = 0.0 if peak == 0.0 else end / peak
    decay = total - warmup

    def schedule(count: int) -> float:
        if count < warmup:  # optax.linear_schedule(0, peak, warmup)
            frac = f32(1) - f32(max(count, 0)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))  # optax.cosine_decay_schedule
        cos = f32(_libm_cosf()(float(f32(math.pi) * c / f32(decay))))
        cosine = f32(0.5) * (f32(1) + cos)
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32), on the device."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


class LoopOptimizer:
    """`make_optimizer`'s transform over a list of parameter tensors, which
    it updates in place: clip by global norm, AdamW on the schedule, under
    MultiSteps when grad_accum > 1."""

    def __init__(self, tc: TrainConfig, params: Sequence[torch.Tensor]):
        self.tc = tc
        self.params = list(params)
        self.schedule = make_lr_schedule(tc)
        self.k = max(1, tc.grad_accum)
        self.adam = torch.optim.AdamW(self.params, lr=0.0, weight_decay=tc.weight_decay)
        # AdamW's state, made now rather than at its first step, so that the
        # state dict has one structure from the start (a resume restores
        # into it).
        for p in self.params:
            self.adam.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
        self.count = 0       # optimizer updates so far: the schedule's count
        self.mini_step = 0   # micro-steps accumulated toward the next update
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None
        self.replicas: List[List[torch.Tensor]] = []  # copies of one piece across devices

    def set_replicas(self, groups: List[List[torch.Tensor]]) -> None:
        """Copies of one piece on different devices (`sharding.replica_groups`):
        each takes the sum of the copies' gradients, and the global norm
        counts the piece once."""
        self.replicas = groups

    def update(self, grads: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        """Take one micro-step's gradients. On a micro-step that updates,
        apply the update and return the global norm before clipping (a
        device scalar); on an accumulating mini-step return None."""
        with torch.no_grad():
            if self.replicas:
                by_id = {id(p): g for p, g in zip(self.params, grads)}
                sum_replica_grads(self.replicas, by_id)
                grads = [by_id[id(p)] for p in self.params]
            if self.acc is not None:
                n = self.mini_step
                for a, g in zip(self.acc, grads):
                    a.copy_(a + (g - a) / (n + 1))
                self.mini_step = (n + 1) % self.k
                if self.mini_step:
                    return None
                grads = self.acc
            skip = {id(t) for copies in self.replicas for t in copies[1:]}
            norm = _global_norm([g for p, g in zip(self.params, grads) if id(p) not in skip])
            max_norm = self.tc.max_grad_norm
            for p, g in zip(self.params, grads):
                p.grad = torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)
            lr = self.schedule(self.count)
            for group in self.adam.param_groups:
                group["lr"] = lr
            self.adam.step()
            self.adam.zero_grad(set_to_none=True)
            self.count += 1
            if self.acc is not None:
                for a in self.acc:
                    a.zero_()
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count, self.mini_step = state["count"], state["mini_step"]
        if self.acc is not None:
            with torch.no_grad():
                for a, s in zip(self.acc, state["acc"]):
                    a.copy_(s)


def make_optimizer(tc: TrainConfig, params: Sequence[torch.Tensor]) -> LoopOptimizer:
    """The loop's optimizer over `params` (a torch optimizer is bound to
    its tensors, so they are an argument here)."""
    return LoopOptimizer(tc, params)


def make_loop_step(
    cfg: FluxConfig,
    tc: TrainConfig,
    opt: LoopOptimizer,
    loss_fn: Callable = flow_matching_loss,
    mesh=None,
    param_sharding=None,
    batch_sharding=None,
):
    """(params, ema, batch, generator) -> (loss, grad norm or None): one
    micro-step on the tensors `opt` holds (the leaves of `params`, in
    order; a sharded tree's pieces), then the EMA, d * e + (1 - d) * p, on
    every micro-step (on a mini-step the parameters have not moved). With
    `mesh`, the layout is checked as `train_step.make_train_step` does."""

    def step(params, ema, batch, generator):
        check_layout(params, mesh, param_sharding, batch_sharding)
        loss = loss_fn(params, cfg, batch, generator)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True, materialize_grads=True)
        norm = opt.update(grads)
        if tc.ema_decay > 0.0:
            d = tc.ema_decay
            with torch.no_grad():
                for e, p in zip(trainable_leaves(ema), opt.params):
                    e.copy_(d * e + (1.0 - d) * p)
        return loss.detach(), norm

    return step


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def latest_checkpoint(ckpt_dir: Optional[str]) -> Optional[Tuple[int, str]]:
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    )
    if not steps:
        return None
    return steps[-1], _ckpt_path(ckpt_dir, steps[-1])


def step_seed(seed: int, step: int) -> int:
    """The seed of micro-step `step`'s generator: a function of (seed, step)
    alone, as JAX's fold_in(key, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def train_loop(
    params: Dict[str, Any],
    cfg: FluxConfig,
    data: Iterator[Dict[str, torch.Tensor]],
    tc: TrainConfig,
    seed: int = 0,
    loss_fn: Callable = flow_matching_loss,
    mesh=None,
    param_sharding=None,
    batch_sharding=None,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run `tc.total_steps` micro-steps on copies of `params` (the caller's
    tensors are left as they are); returns {"params", "ema", "step",
    "losses", "grad_norms"}, the norms one per optimizer update.

    `loss_fn(params, cfg, batch, generator)` draws its randomness from the
    step's generator, on the parameters' device. Resume: when
    `tc.checkpoint_dir` holds a step_XXXXXXXX checkpoint, the state restores
    from the latest and the loop continues at that step.

    With `mesh`, `params` must be laid out over it (`shard_params_fsdp`);
    the copies, the EMA, the optimizer state and the checkpoints keep that
    layout (a checkpoint holds the pieces), and "params" / "ema" come back
    as `Sharded` trees (`parallel.sharding.gather_tree` reassembles one).
    """
    from conceptattention_torch.utils.checkpoint import load_params, save_params

    check_layout(params, mesh, param_sharding, batch_sharding)
    params = _map_tensors(lambda x: x.detach().clone().requires_grad_(True), params)
    ema = _map_tensors(lambda x: x.detach().clone(), params)
    opt = make_optimizer(tc, trainable_leaves(params))
    if mesh is not None:
        opt.set_replicas(replica_groups(params))
    device = opt.params[0].device
    start = 0

    latest = latest_checkpoint(tc.checkpoint_dir)
    if latest is not None:
        start, path = latest
        restored = load_params(path, like=_state(params, ema, opt))
        with torch.no_grad():
            for dst, src in zip(opt.params, tree_leaves(restored["params"])):
                dst.copy_(src)
            for dst, src in zip(trainable_leaves(ema), tree_leaves(restored["ema"])):
                dst.copy_(src)
        opt.load_state_dict(restored["opt_state"])
        del restored
        for _ in range(start):  # keep the data stream aligned
            next(data)
        log(f"resumed from {path} at step {start}")

    step_fn = make_loop_step(cfg, tc, opt, loss_fn=loss_fn, mesh=mesh,
                             param_sharding=param_sharding, batch_sharding=batch_sharding)

    losses: List[float] = []
    norms: List[float] = []
    pending: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
    # fetched lazily: reading a loss waits for the card, so it happens only
    # at a log, a save or the end

    def drain():
        for loss, norm in pending:
            losses.append(float(loss))
            if norm is not None:
                norms.append(float(norm))
        pending.clear()

    for i in range(start, tc.total_steps):
        batch = next(data)
        gen = torch.Generator(device).manual_seed(step_seed(seed, i))
        pending.append(step_fn(params, ema, batch, gen))
        if (i + 1) % tc.log_every == 0:
            drain()
            log(f"step {i + 1}/{tc.total_steps} loss {losses[-1]:.5f}")
        if tc.checkpoint_dir and (i + 1) % tc.checkpoint_every == 0:
            drain()
            save_params(_ckpt_path(tc.checkpoint_dir, i + 1), _state(params, ema, opt))
    drain()
    return {"params": _map_tensors(lambda x: x.detach(), params), "ema": ema,
            "step": tc.total_steps, "losses": losses, "grad_norms": norms}


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """fn over a tree's tensors, and over each distinct piece of its
    `Sharded` leaves (keeping their layout)."""
    return tree_map(lambda x: x.map(fn) if isinstance(x, Sharded) else fn(x), tree)


def _state(params, ema, opt: LoopOptimizer) -> Dict[str, Any]:
    """What a checkpoint holds: the parameters and the EMA (a sharded
    tree's pieces, in `trainable_leaves` order) and the optimizer state."""
    if tree_mesh(params) is not None:
        return {"params": trainable_leaves(params), "ema": trainable_leaves(ema),
                "opt_state": opt.state_dict()}
    return {"params": params, "ema": ema, "opt_state": opt.state_dict()}
