"""Flux DiT forward pass with the optional concept stream.

Counterpart of the JAX package's `models/flux/dit.py`: Python loops over
the 19 double and 38 single blocks of the stacked parameters. With
`concepts=None` this is the vanilla Flux forward; with concepts it adds the
third token stream and emits per-layer saliency maps.
`stop_after_multimodal_attentions` returns after the double blocks.
ControlNet residuals are added to the image stream after each block. With
`remat`, each block (its residual included) runs under
`torch.utils.checkpoint`: its backward recomputes the block from its inputs
instead of keeping every activation of every layer (the JAX package's
`jax.checkpoint` over the scan body; the training path sets it). A
parameter tree laid out over a mesh runs data- and tensor-parallel over it
(`flux_forward`). `make_jitted_forward` is the counterpart of `jax.jit` over
the forward: on the card, a CUDA graph captured once per input signature and
replayed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.kernels._autograd import refuse_autograd
from conceptattention_torch.models.flux.blocks import double_block, last_layer, single_block
from conceptattention_torch.models.flux.params import layer
from conceptattention_torch.ops.attention import RING_BACKENDS, ConceptAttentionSpec
from conceptattention_torch.ops.embeddings import mlp_embedder, timestep_embedding
from conceptattention_torch.ops.rope import embed_nd
from conceptattention_torch.parallel.collectives import Sharded
from conceptattention_torch.parallel.mesh import AXES
from conceptattention_torch.parallel.sharding import rank_tree, restrict_tree, tree_mesh
from conceptattention_torch.utils.profiling import DIT_FORWARD, span


def _conditioning_vector(params, cfg: FluxConfig, timesteps, guidance, y):
    vec = mlp_embedder(timestep_embedding(timesteps, 256), params["time_in"])
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance_embed model requires a guidance strength")
        vec = vec + mlp_embedder(timestep_embedding(guidance, 256), params["guidance_in"])
    return vec + mlp_embedder(y, params["vector_in"])


def _controlnet_per_layer(samples: Optional[torch.Tensor], depth: int, repeat: bool):
    """[n, B, P, D] ControlNet residuals -> one [B, P, D] residual per layer
    (views): sample i % n when `repeat` (the XLabs layout), else
    i // ceil(depth / n) (diffusers' interval layout). None gives None."""
    if samples is None:
        return None
    n = samples.shape[0]
    if repeat:
        return [samples[i % n] for i in range(depth)]
    interval = -(-depth // n)  # ceil
    return [samples[min(i // interval, n - 1)] for i in range(depth)]


def _step(fn, remat: bool, *args):
    """fn(*args), under a non-reentrant checkpoint with `remat`. The layer's
    parameters are taken inside `fn`, so a derived view of them (a LoRA
    merge) is recomputed with the block rather than kept."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def flux_forward(
    params: Dict[str, Any],
    cfg: FluxConfig,
    img: torch.Tensor,
    img_ids: torch.Tensor,
    txt: torch.Tensor,
    txt_ids: torch.Tensor,
    timesteps: torch.Tensor,
    y: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    concepts: Optional[torch.Tensor] = None,
    concept_ids: Optional[torch.Tensor] = None,
    concept_vec: Optional[torch.Tensor] = None,
    stop_after_multimodal_attentions: bool = False,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
    controlnet_block_samples: Optional[torch.Tensor] = None,
    controlnet_single_block_samples: Optional[torch.Tensor] = None,
    controlnet_blocks_repeat: bool = False,
    remat: bool = False,
    text_embedder: Optional[Callable] = None,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """Run the DiT.

    Args:
      img: [B, P, in_channels] packed latents; txt: [B, T, context_in_dim].
      img_ids / txt_ids / concept_ids: [B, L, 3] position ids.
      timesteps: [B] flow time in [0, 1]; y: [B, vec_in_dim] pooled vector.
      concepts: [B, C, context_in_dim] concept embeddings, or None.
      concept_vec: [B, vec_in_dim] concept pooled vector (zeros).
      controlnet_block_samples: [n, B, P, hidden] residuals added to the img
        stream after each double block, laid out per
        `controlnet_blocks_repeat` (`_controlnet_per_layer`).
      controlnet_single_block_samples: [m, B, P, hidden] residuals added to
        the image slice after each single block (interval layout).
      remat: rematerialize each block in the backward
        (`torch.utils.checkpoint`, non-reentrant).
      text_embedder: `fn(params, x, timesteps)` that embeds the text and the
        concepts, each sequence on its own; None is Flux's linear `txt_in`
        (HunyuanVideo passes its token refiner, `models/video/hunyuan.py`).

    A parameter tree laid out over a mesh (`parallel.sharding.shard_params`,
    `parallel.fsdp.shard_params_fsdp`) runs over that mesh: the batch split
    over `data` when it divides (each slice on its own ranks; otherwise
    the whole batch on the first slice), both block stacks tensor-parallel
    over `model`, and any dimension a parameter shards over `data` (FSDP)
    gathered one layer at a time inside the block (inside its
    rematerialization with `remat`). The outputs come back on the mesh's
    first device.

    Returns (pred, saliency): pred [B, P, in_channels] (None when stopping
    after the double blocks), saliency {tap: [depth, B, C, P] f32} (empty
    without concepts; with `spec.return_raw_vectors`, the blocks' vector
    sets stacked over depth).
    """
    if img.dim() != 3 or txt.dim() != 3:
        raise ValueError("img and txt must be [B, L, D]")
    inputs = dict(img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids, timesteps=timesteps, y=y,
                  guidance=guidance, concepts=concepts, concept_ids=concept_ids,
                  concept_vec=concept_vec)
    controlnet = (controlnet_block_samples, controlnet_single_block_samples)
    with span(DIT_FORWARD):
        mesh = tree_mesh(params)
        if mesh is None:
            return _forward(params, lambda key, i: layer(params[key], i), None, cfg, inputs,
                            controlnet, controlnet_blocks_repeat, stop_after_multimodal_attentions,
                            spec, remat, text_embedder or _txt_in)
        return _sharded_forward(params, mesh, cfg, inputs, controlnet, controlnet_blocks_repeat,
                                stop_after_multimodal_attentions, spec, remat,
                                text_embedder or _txt_in)


def _txt_in(params, x, timesteps):
    """Flux's text embedder: the linear `txt_in`."""
    return x @ params["txt_in"]["w"] + params["txt_in"]["b"]


def _sharded_forward(params, mesh, cfg, inputs, controlnet, repeat, stop_after, spec, remat,
                     text_embedder):
    """`_forward` once for each data slice of the mesh on its rows, with
    the slice's parameters (FSDP dimensions gathered per layer) and tensor
    parallelism over `model` when that axis is above 1."""
    n_data = mesh.shape[AXES.data]
    b = inputs["img"].shape[0]
    slices = n_data if n_data > 1 and b % n_data == 0 else 1
    rows = b // slices
    tp = AXES.model if mesh.shape[AXES.model] > 1 else None
    fixed = {a: 0 for a in (AXES.pipe, AXES.expert)}
    stacks = ("double", "single")
    first = mesh.devices.flat[0]
    preds, saliencies = [], []
    for d in range(slices):
        home = mesh.devices[d, 0, 0, 0, 0]
        top = rank_tree(restrict_tree({k: v for k, v in params.items() if k not in stacks},
                                      data=d, **fixed), (0,) * mesh.devices.ndim)

        def get_layer(key, i, d=d):
            lp = restrict_tree(layer(params[key], i), data=d, **fixed)
            return lp if tp else rank_tree(lp, (0,) * mesh.devices.ndim)

        def cut(x, dim=0, d=d):
            if x is None:
                return None
            return x.narrow(dim, d * rows, rows).to(home) if slices > 1 else x.to(home)

        part = {k: cut(v) for k, v in inputs.items()}
        cn = tuple(cut(c, 1) for c in controlnet)
        slice_spec = spec
        if spec.backend in RING_BACKENDS and spec.mesh is not None and slices > 1:
            # the slice's rows run the seq rings of its data index
            slice_spec = dataclasses.replace(spec, mesh=spec.mesh.sub(data=d), batch_axis=None)
        pred, sal = _forward(top, get_layer, tp, cfg, part, cn, repeat, stop_after, slice_spec,
                             remat, text_embedder)
        preds.append(None if pred is None else pred.to(first))
        saliencies.append({k: v.to(first) for k, v in sal.items()})
    pred = None if preds[0] is None else torch.cat(preds)
    saliency = {k: torch.cat([s[k] for s in saliencies], dim=1) for k in saliencies[0]}
    return pred, saliency


def _forward(params, get_layer, tp_axis, cfg, inputs, controlnet, controlnet_blocks_repeat,
             stop_after_multimodal_attentions, spec, remat, text_embedder):
    """The forward on one slice: `params` holds the non-stacked leaves,
    `get_layer(key, i)` layer i of the "double" / "single" stack (taken
    inside each block's step, so under remat its gather is recomputed);
    `text_embedder(params, x, timesteps)` embeds the text and the concepts."""
    img, img_ids, txt, txt_ids = inputs["img"], inputs["img_ids"], inputs["txt"], inputs["txt_ids"]
    timesteps, y, guidance = inputs["timesteps"], inputs["y"], inputs["guidance"]
    concepts, concept_ids, concept_vec = (inputs["concepts"], inputs["concept_ids"],
                                          inputs["concept_vec"])
    controlnet_block_samples, controlnet_single_block_samples = controlnet
    img = img @ params["img_in"]["w"] + params["img_in"]["b"]
    txt = text_embedder(params, txt, timesteps)
    vec = _conditioning_vector(params, cfg, timesteps, guidance, y).to(img.dtype)
    pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)

    concept_pe = cvec = None
    if concepts is not None:
        cvec = _conditioning_vector(params, cfg, timesteps, guidance, concept_vec).to(img.dtype)
        concepts = text_embedder(params, concepts, timesteps)
        concept_pe = embed_nd(
            torch.cat([concept_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta
        )

    cn_double = _controlnet_per_layer(controlnet_block_samples, cfg.depth,
                                      controlnet_blocks_repeat)

    def double_step(i, img, txt, concepts):
        img, txt, concepts, saliency = double_block(
            get_layer("double", i), img, txt, vec, pe, cfg.num_heads,
            concepts=concepts, concept_vec=cvec, concept_pe=concept_pe, spec=spec,
            tp_axis=tp_axis,
        )
        if cn_double is not None:
            img = img + cn_double[i].to(img.dtype)
        return img, txt, concepts, saliency

    per_layer = []
    for i in range(cfg.depth):
        img, txt, concepts, saliency = _step(double_step, remat, i, img, txt, concepts)
        per_layer.append(saliency)
    saliency = {k: torch.stack([s[k] for s in per_layer]) for k in per_layer[0]}

    if stop_after_multimodal_attentions:
        return None, saliency

    t_len = txt.shape[1]
    x = torch.cat([txt, img], dim=1)
    cn_single = _controlnet_per_layer(controlnet_single_block_samples,
                                      cfg.depth_single_blocks, False)

    def single_step(i, x):
        x = single_block(
            get_layer("single", i), x, vec, pe, cfg.num_heads, cfg.mlp_hidden_dim,
            backend=spec.backend, int8_qk=spec.int8_qk, tp_axis=tp_axis,
        )
        if cn_single is not None:  # the residual lands on the image slice only
            x = torch.cat([x[:, :t_len], x[:, t_len:] + cn_single[i].to(x.dtype)], dim=1)
        return x

    for i in range(cfg.depth_single_blocks):
        x = _step(single_step, remat, i, x)
    pred = last_layer(params["final"], x[:, t_len:], vec)
    return pred, saliency


def _leaves(tree):
    """The tensors of a parameter tree, a `Sharded` leaf's pieces included."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Sharded):
        for piece in tree.grid.flat:
            yield piece
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _signature(params, kwargs) -> tuple:
    """What a captured graph is valid for: each keyword's shape, dtype and
    device (None where it is None; a non-tensor's value), and the address,
    shape and dtype of every parameter tensor (the graph reads them where
    they lay at capture)."""
    inputs = tuple(
        (k, None) if v is None
        else (k, tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
        else (k, v)
        for k, v in sorted(kwargs.items()))
    return inputs, tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in _leaves(params))


class _Replay:
    """One captured forward: the graph, its static input buffers and
    outputs, and the kernel launches it holds (`kernels.launch_counts` keys)."""

    def __init__(self, fwd, params, kwargs, device):
        from conceptattention_torch.kernels import add_launches, launch_counts

        self.inputs = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in kwargs.items()}
        # One warm call on a side stream first: it loads the kernels'
        # libraries and the entry point of cuTensorMapEncodeTiled, and lets
        # the allocator see the forward, before capture begins.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fwd(params, self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fwd(params, self.inputs)
        except Exception as e:
            raise RuntimeError(
                "make_jitted_forward: capturing flux_forward into a CUDA graph failed "
                f"({type(e).__name__}: {e}); it does not fall back to the eager forward") from e
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}
        # the wrappers counted while the graph was recorded, and nothing ran
        add_launches({k: -v for k, v in self.launches.items()})

    def __call__(self, kwargs):
        from conceptattention_torch.kernels import add_launches

        with span(DIT_FORWARD):
            for k, v in kwargs.items():
                if isinstance(v, torch.Tensor):
                    self.inputs[k].copy_(v)
            self.graph.replay()
            add_launches(self.launches)
            pred, saliency = self.outputs
            return (None if pred is None else pred.clone(),
                    {k: v.clone() for k, v in saliency.items()})


def make_jitted_forward(cfg: FluxConfig, **static_kwargs):
    """The forward with `cfg` and `static_kwargs` closed over: `fwd(params,
    img=..., ...)` returns `flux_forward`'s (pred, saliency).

    Array inputs must be passed by KEYWORD, as in the JAX package: cfg holds
    the second positional slot of flux_forward, so a positional array raises
    TypeError. Runs under `torch.no_grad()` and refuses inputs that require
    grad while autograd is on (the forward carries no gradient, as the
    kernels do not). On CPU tensors it calls `flux_forward`. On the card it
    is the port's `jax.jit`: the first call of each signature (inputs'
    shapes, dtypes and None pattern, and the parameters' addresses) captures
    the forward into a CUDA graph, and every call replays it on a copy of
    its inputs and returns fresh outputs (a later replay does not overwrite
    them). A replay adds the launches it holds to `kernels.launch_counts`. A
    capture that fails raises; it never runs the eager forward instead.
    """
    graphs = {}

    def forward(params, inputs):
        return flux_forward(params, cfg=cfg, **static_kwargs, **inputs)

    def fwd(params, **kwargs):
        refuse_autograd("make_jitted_forward", *_leaves(params),
                        *(v for v in kwargs.values() if isinstance(v, torch.Tensor)))
        with torch.no_grad():
            img = kwargs.get("img")
            if not isinstance(img, torch.Tensor) or img.device.type != "cuda":
                return forward(params, kwargs)
            key = _signature(params, kwargs)
            replay = graphs.get(key)
            if replay is None:
                replay = graphs[key] = _Replay(forward, params, kwargs, img.device)
            return replay(kwargs)

    fwd.graphs = graphs
    return fwd
