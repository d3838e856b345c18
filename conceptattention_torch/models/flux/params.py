"""Flux DiT parameters: random init in the JAX package's layout.

Counterpart of the JAX package's `models/flux/params.py`. The parameters
are a nested dict of tensors: linear weights `{w: [in, out], b: [out]}`, the
fused qkv weight `[D, 3, H, head_dim]`, and per-layer parameters stacked along
a leading depth axis under "double" and "single", so a parameter tree from
the JAX package converts leaf by leaf (`weights/from_jax.py`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from conceptattention_torch.config import FluxConfig

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply `fn` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def stack_layers(make_layer: Callable[[int], Params], depth: int) -> Params:
    """Layers 0..depth-1 of `make_layer(i)` stacked along a new leading axis
    on their own device, each copied into its slot as it is made, so only one
    layer exists beside the stack."""
    first = make_layer(0)
    stack = tree_map(
        lambda x: torch.empty((depth, *x.shape), dtype=x.dtype, device=x.device), first
    )
    for i in range(depth):
        src = first if i == 0 else make_layer(i)
        for dst_leaf, src_leaf in zip(tree_leaves(stack), tree_leaves(src)):
            dst_leaf[i].copy_(src_leaf)
    return stack


def layer(stacked: Params, i: int) -> Params:
    """Layer i of a depth-stacked parameter tree (views, no copies)."""
    return tree_map(lambda x: x[i], stacked)


class _Init:
    """Draws weights from one generator on its device, in f32, then casts."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype):
        self.gen = generator
        self.dtype = dtype
        self.device = generator.device

    def normal(self, shape, scale: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return (x * scale).to(self.dtype)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def linear(self, d_in: int, d_out: int, bias: bool = True) -> Params:
        p = {"w": self.normal((d_in, d_out), d_in**-0.5)}
        if bias:
            p["b"] = self.const((d_out,), 0.0)
        return p

    def mlp_embedder(self, d_in: int, d_hidden: int) -> Params:
        return {"in": self.linear(d_in, d_hidden), "out": self.linear(d_hidden, d_hidden)}

    def qkv(self, cfg: FluxConfig, bias: bool) -> Params:
        d = cfg.hidden_size
        p = {"w": self.normal((d, 3, cfg.num_heads, cfg.head_dim), d**-0.5)}
        if bias:
            p["b"] = self.const((3, cfg.num_heads, cfg.head_dim), 0.0)
        return p

    def double_block(self, cfg: FluxConfig) -> Params:
        d, m = cfg.hidden_size, cfg.mlp_hidden_dim
        p = {}
        for stream in ("img", "txt"):
            p[f"{stream}_mod"] = self.linear(d, 6 * d)
            p[f"{stream}_qkv"] = self.qkv(cfg, bias=cfg.qkv_bias)
            p[f"{stream}_qnorm"] = self.const((cfg.head_dim,), 1.0)
            p[f"{stream}_knorm"] = self.const((cfg.head_dim,), 1.0)
            p[f"{stream}_proj"] = self.linear(d, d)
            p[f"{stream}_mlp_in"] = self.linear(d, m)
            p[f"{stream}_mlp_out"] = self.linear(m, d)
        return p

    def single_block(self, cfg: FluxConfig) -> Params:
        d, m = cfg.hidden_size, cfg.mlp_hidden_dim
        return {
            "mod": self.linear(d, 3 * d),
            "qkv": self.qkv(cfg, bias=True),
            "mlp_in": self.linear(d, m),
            "proj": self.linear(d, d),
            "mlp_out": self.linear(m, d, bias=False),
            "qnorm": self.const((cfg.head_dim,), 1.0),
            "knorm": self.const((cfg.head_dim,), 1.0),
        }

    def stacked(self, make_layer: Callable[[], Params], depth: int) -> Params:
        """Depth-stacked layers, drawn one layer at a time."""
        return stack_layers(lambda _: make_layer(), depth)


def init_flux_params(
    generator: torch.Generator, cfg: FluxConfig, dtype: torch.dtype = torch.bfloat16
) -> Params:
    """Randomly initialized Flux DiT parameters on the generator's device,
    with the JAX package's distributions: linear and qkv weights
    N(0, 1/in_features), zero biases, unit norm scales."""
    init = _Init(generator, dtype)
    d = cfg.hidden_size
    params: Params = {
        "img_in": init.linear(cfg.in_channels, d),
        "txt_in": init.linear(cfg.context_in_dim, d),
        "time_in": init.mlp_embedder(256, d),
        "vector_in": init.mlp_embedder(cfg.vec_in_dim, d),
        "final": {"adaln": init.linear(d, 2 * d), "linear": init.linear(d, cfg.in_channels)},
    }
    if cfg.guidance_embed:
        params["guidance_in"] = init.mlp_embedder(256, d)
    params["double"] = init.stacked(lambda: init.double_block(cfg), cfg.depth)
    params["single"] = init.stacked(lambda: init.single_block(cfg), cfg.depth_single_blocks)
    return params


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
