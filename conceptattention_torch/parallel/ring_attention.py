"""Ring attention over the `seq` mesh axis, in plain PyTorch (the "ring" backend).

Counterpart of the JAX package's `parallel/ring_attention.py`. The sequence
is split into N equal chunks, one per rank of the ring. Each rank keeps its
query chunk; the K/V chunks move one rank to the right per ring step, and
each rank folds the chunk it holds into an online softmax (Liu et al. 2023),
so no rank ever holds the whole sequence's keys at once.

Where the JAX package runs one program per device under `shard_map`, the
functions here take the ranks' shards as lists (`qs[r]` on rank r's device)
and step all ranks together: at each step every rank updates against its
current chunk, and each chunk is copied into the next rank's buffer. The
`make_*` functions return callables on whole [B, H, S, D] tensors that split
S over the mesh's `seq` devices and concatenate the outputs on the first.

The online softmax runs in the exp2 domain with the JAX rounding points: f32
scores, P cast to v's dtype, f32 accumulation. This is also the plain version
of the CUDA ring kernel (`kernels/ring_rdma.py`, K4).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from conceptattention_torch.parallel.mesh import Mesh

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # log2(e): the online softmax runs in the exp2 domain

Shards = List[torch.Tensor]


def _partial_update(q, k, v, m, l, acc, scale, allowed=None):
    """One online-softmax accumulation of q against a K/V chunk.

    q [B,H,Lq,D], k/v [B,H,Lk,D]; m/l [B,H,Lq,1], acc [B,H,Lq,D] f32.
    `allowed` is an optional [Lq, Lk] bool mask in global index space.
    """
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if allowed is not None:
        s = s.masked_fill(~allowed, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m_new)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    alpha = torch.exp2(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + p.to(v.dtype).float() @ v.float()
    return m_new, l_new, acc_new


def _segment_mask(q_idx, k_idx, txt_len, img_len, concept_len, cross, self_attention):
    """[Lq, Lk] reachability over the fused [txt | img | concept | pad]
    sequence: joint queries see joint keys; concept queries see image keys
    (cross) and/or concept keys (self); padding reaches nothing."""
    joint_end = txt_len + img_len
    concept_end = joint_end + concept_len
    qg, kg = q_idx[:, None], k_idx[None, :]
    allowed = (qg < joint_end) & (kg < joint_end)
    concept_keys = torch.zeros_like(allowed)
    if cross:
        concept_keys = concept_keys | ((kg >= txt_len) & (kg < joint_end))
    if self_attention:
        concept_keys = concept_keys | ((kg >= joint_end) & (kg < concept_end))
    return allowed | ((qg >= joint_end) & (qg < concept_end) & concept_keys)


def _ring(qs: Shards, ks: Shards, vs: Shards,
          mask: Optional[Callable[[int, int, torch.device], torch.Tensor]]):
    """The ring loop: returns each rank's (l, acc). `mask(my, src, device)`
    gives the [Lc, Lc] mask of rank my's queries against the chunk that
    originated at rank src."""
    n = len(qs)
    scale = LOG2E / math.sqrt(qs[0].shape[-1])
    b, h, lc, d = qs[0].shape
    devices = [q.device for q in qs]
    state = [
        (torch.full((b, h, lc, 1), NEG_INF, device=dev), torch.zeros((b, h, lc, 1), device=dev),
         torch.zeros((b, h, lc, d), device=dev))
        for dev in devices
    ]
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        if step + 1 < n:  # each chunk moves into the next rank's buffer
            k_nxt = [k_cur[r - 1].to(devices[r], copy=True) for r in range(n)]
            v_nxt = [v_cur[r - 1].to(devices[r], copy=True) for r in range(n)]
        for my in range(n):
            src = (my - step) % n  # origin rank of the chunk rank `my` holds
            allowed = None if mask is None else mask(my, src, devices[my])
            state[my] = _partial_update(qs[my], k_cur[my], v_cur[my], *state[my], scale, allowed)
        if step + 1 < n:
            k_cur, v_cur = k_nxt, v_nxt
    return [(l, acc) for _, l, acc in state]


def ring_attention(qs: Shards, ks: Shards, vs: Shards) -> Shards:
    """Exact attention of each rank's query chunk over the whole sequence,
    with the K/V chunks rotating around the ring. qs/ks/vs: one [B, H, Lc, D]
    shard per rank; returns one output shard per rank, in v's dtype."""
    return [(acc / torch.clamp(l, min=1e-30)).to(v.dtype)
            for (l, acc), v in zip(_ring(qs, ks, vs, None), vs)]


def ring_concept_attention(
    qs: Shards, ks: Shards, vs: Shards,
    txt_len: int, img_len: int, concept_len: int,
    cross: bool = True, self_attention: bool = True,
) -> Shards:
    """Dual-pass (joint txt+img and concept) attention over the fused
    sequence [txt | img | concept | pad] split over the ring. Each chunk's
    global key positions come from the ring step, so the result equals the
    dense fused attention, with padded rows exactly zero."""
    lc = qs[0].shape[2]

    def mask(my, src, device):
        iota = torch.arange(lc, device=device)
        return _segment_mask(my * lc + iota, src * lc + iota, txt_len, img_len, concept_len,
                             cross, self_attention)

    out = []
    for (l, acc), v in zip(_ring(qs, ks, vs, mask), vs):
        out.append((acc / torch.where(l == 0, torch.ones_like(l), l)).to(v.dtype))
    return out


def shard_over_ring(mesh: Mesh, axis_name: str, ring_fn: Callable[..., Shards],
                    batch_axis: Optional[str] = None, head_axis: Optional[str] = None):
    """A callable on whole [B, H, S, D] q/k/v that splits S into one chunk
    per device of the mesh's `axis_name`, runs `ring_fn(qs, ks, vs)` and
    concatenates the output shards on the mesh's first device (the port's
    stand-in for `shard_map`). S must be a multiple of the ring size.

    `batch_axis` / `head_axis` compose the ring with data and tensor
    parallelism in one mesh (dp x sp x tp): B splits over `batch_axis`, H
    over `head_axis`, and each (data, model) slice runs its own ring over
    the `axis_name` devices at its indices, on its rows and heads (one
    `ring_fn` call per slice, so a kernel's launch groups never mix two
    rings)."""
    for name in (batch_axis, head_axis):
        if name is not None and name not in mesh.axis_names:
            raise ValueError(f"{name!r} is not an axis of the mesh {mesh.axis_names}")
    n_b = mesh.shape[batch_axis] if batch_axis else 1
    n_h = mesh.shape[head_axis] if head_axis else 1
    n = mesh.shape[axis_name]
    first = mesh.devices.flat[0]

    def ring_devices(i, j):
        fixed = {}
        if batch_axis:
            fixed[batch_axis] = i
        if head_axis:
            fixed[head_axis] = j
        return mesh.sub(**fixed).axis_devices(axis_name)

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, h, s = q.shape[:3]
        if s % n:
            raise ValueError(f"sequence length {s} is not a multiple of the ring size {n}")
        if b % n_b or h % n_h:
            raise ValueError(f"[B={b}, H={h}] does not split over {batch_axis}={n_b}, "
                             f"{head_axis}={n_h}")
        lc, bs, hs = s // n, b // n_b, h // n_h
        rows = []
        for i in range(n_b):
            heads = []
            for j in range(n_h):
                devices = ring_devices(i, j)

                def split(x):
                    x = x[i * bs:(i + 1) * bs, j * hs:(j + 1) * hs]
                    return [x[:, :, r * lc:(r + 1) * lc].to(dev).contiguous()
                            for r, dev in enumerate(devices)]

                outs = ring_fn(split(q), split(k), split(v))
                heads.append(torch.cat([o.to(first) for o in outs], dim=2))
            rows.append(torch.cat(heads, dim=1) if n_h > 1 else heads[0])
        return torch.cat(rows) if n_b > 1 else rows[0]

    return fn


def make_ring_attention(mesh: Mesh, axis_name: str = "seq",
                        batch_axis: Optional[str] = None, head_axis: Optional[str] = None):
    """`ring_attention` as a callable on whole [B, H, S, D] tensors."""
    return shard_over_ring(mesh, axis_name, ring_attention, batch_axis, head_axis)


def make_ring_concept_attention(
    mesh: Mesh,
    axis_name: str,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
):
    """`ring_concept_attention` as a callable on whole [B, H, S, D] tensors
    (S a multiple of the ring size; the [txt | img | concept | pad] contract)."""

    def ring_fn(qs, ks, vs):
        return ring_concept_attention(qs, ks, vs, txt_len, img_len, concept_len, cross,
                                      self_attention)

    return shard_over_ring(mesh, axis_name, ring_fn, batch_axis, head_axis)
