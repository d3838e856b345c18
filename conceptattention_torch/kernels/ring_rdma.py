"""Sequence-parallel ring attention (K4): CUDA step kernel, hops, plain version.

Counterpart of the JAX package's `kernels/ring_rdma.py`, the "ring_rdma"
attention backend. The fused sequence is split into N chunks, one per rank of
the mesh's `seq` axis; each rank keeps its query chunk, and the K/V chunks
travel one rank to the right per ring step while each rank folds the chunk
it holds into an online softmax. The masked variant rebuilds each chunk's
global key positions from the ring step and applies the
[txt | img | concept | pad] segment mask, so the result equals the dense
fused concept attention with padded rows exactly zero.

For CUDA tensors `ring_attention_rdma` runs the ring on the card:

- each ring step is one launch of `csrc/ring_attention.cu` per run of
  consecutive ranks that share a device (the rank is a grid axis, so a
  virtual ring on one card is one launch per step); the online-softmax state
  lives between steps in f32 buffers of each rank;
- each rank owns a double-buffered comm buffer [2 slots, 2 (k, v), B, H, Lc,
  D], as the JAX kernel's `kv_comm`. The hop of step s copies the chunk rank
  r holds (its input at step 0, slot s % 2 after) into slot (s + 1) % 2 of
  rank r + 1, on a copy stream of rank r's device, while step s computes on
  the compute stream. Between two cards the copy is a peer copy; on one card
  a device copy, so a virtual ring moves the bytes a real ring moves;
- CUDA events take the place of the JAX kernel's semaphores: a hop waits for
  the step that last read the slot it overwrites and for the hop that last
  sent from it (the "free" credit); step s + 1 waits for the hop that filled
  its slot (the "recv"); at the end each compute stream waits for the hops
  that read its buffers.

For CPU tensors it runs `ring_attention_rdma_plain`, the "ring" backend of
`parallel/ring_attention.py`; it never falls back from one to the other.
`ring_attention_rdma.launches` counts the calls that launch the kernel,
`ring_attention_rdma.step_launches` the kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional

import torch

from conceptattention_torch.kernels import _build
from conceptattention_torch.parallel.mesh import Mesh
from conceptattention_torch.parallel.ring_attention import (
    LOG2E,
    Shards,
    ring_attention,
    ring_concept_attention,
    shard_over_ring,
)

KERNEL_HEAD_DIMS = (32, 64, 128)
MAX_LOCAL_RANKS = 8  # ranks one launch covers (csrc/ring_attention.cu)

_copy_streams: Dict[torch.device, torch.cuda.Stream] = {}


def ring_attention_rdma_plain(
    qs: Shards, ks: Shards, vs: Shards, masked: bool = False, txt_len: int = 0,
    img_len: int = 0, concept_len: int = 0, cross: bool = True, self_attention: bool = True,
) -> Shards:
    """K4's function in plain PyTorch: the "ring" backend's ring."""
    if masked:
        return ring_concept_attention(qs, ks, vs, txt_len, img_len, concept_len, cross,
                                      self_attention)
    return ring_attention(qs, ks, vs)


def _library() -> ctypes.CDLL:
    lib = _build.load("ring_attention")
    if lib.ca_ring_flash_step_bf16.argtypes is None:
        ptrs, i = ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
        lib.ca_ring_flash_step_bf16.argtypes = [
            ptrs, ptrs, ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_int),
            i, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.ca_ring_copy.argtypes = [ctypes.c_void_p, i, ctypes.c_void_p, i, ctypes.c_size_t,
                                     ctypes.c_void_p]
        lib.ca_ring_flash_step_bf16.restype = lib.ca_ring_copy.restype = i
    return lib


def _check_inputs(qs, ks, vs, txt_len, img_len, concept_len):
    n = len(qs)
    if n < 1 or len(ks) != n or len(vs) != n:
        raise ValueError(f"one q, k and v shard per rank: {len(qs)} / {len(ks)} / {len(vs)}")
    shape = qs[0].shape
    if len(shape) != 4 or shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the ring kernel takes [B, H, Lc, D] shards with D in "
                         f"{KERNEL_HEAD_DIMS}, got {tuple(shape)}")
    for r, group in enumerate(zip(qs, ks, vs)):
        for name, t in zip("qkv", group):
            if t.dtype != torch.bfloat16:
                raise TypeError(f"the ring kernel takes bf16 shards, got {name}[{r}] {t.dtype}")
            if t.shape != shape or t.device != group[0].device or t.device.type != "cuda":
                raise ValueError(f"{name}[{r}] must be a CUDA [B, H, Lc, D] shard {tuple(shape)} "
                                 f"on q[{r}]'s device, got {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}[{r}] must be contiguous")
    if min(txt_len, img_len, concept_len) < 0 or txt_len + img_len + concept_len > n * shape[2]:
        raise ValueError(f"segments {txt_len}+{img_len}+{concept_len} exceed S={n * shape[2]}")


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _copy_streams.get(device)
    if stream is None:
        stream = _copy_streams[device] = torch.cuda.Stream(device=device)
    return stream


def _event(stream) -> torch.cuda.Event:
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _launch_groups(devices: List[torch.device]) -> List[List[int]]:
    """Runs of consecutive ranks on one device, at most MAX_LOCAL_RANKS each:
    one kernel launch per run and step."""
    groups: List[List[int]] = []
    for r, dev in enumerate(devices):
        if groups and devices[groups[-1][0]] == dev and len(groups[-1]) < MAX_LOCAL_RANKS:
            groups[-1].append(r)
        else:
            groups.append([r])
    return groups


def ring_attention_rdma(
    qs: Shards,
    ks: Shards,
    vs: Shards,
    *,
    masked: bool = False,
    txt_len: int = 0,
    img_len: int = 0,
    concept_len: int = 0,
    cross: bool = True,
    self_attention: bool = True,
) -> Shards:
    """Ring attention over per-rank shards [B, H, Lc, D] (rank r's q, k and v
    on rank r's device; the sequence is the ranks' chunks in order). Equals
    `ring_attention` (masked=False) or `ring_concept_attention` (masked=True,
    segment lengths in positions of the whole sequence). Returns one output
    shard per rank, in bf16 for the kernel."""
    if all(q.device.type == "cpu" for q in qs):
        return ring_attention_rdma_plain(qs, ks, vs, masked, txt_len, img_len, concept_len,
                                         cross, self_attention)
    _check_inputs(qs, ks, vs, txt_len, img_len, concept_len)
    n = len(qs)
    b, h, lc, d = qs[0].shape
    if not masked:  # every position joint: nothing is masked but the chunk tails
        txt_len, img_len, concept_len = n * lc, 0, 0
    devices = [q.device for q in qs]
    lib = _library()

    out = [torch.empty_like(q) for q in qs]
    comm = acc = ml = [None] * n
    if n > 1:
        comm = [torch.empty((2, 2, b, h, lc, d), dtype=torch.bfloat16, device=dev) for dev in devices]
        acc = [torch.empty((b, h, lc, d), dtype=torch.float32, device=dev) for dev in devices]
        ml = [torch.empty((b, h, lc, 2), dtype=torch.float32, device=dev) for dev in devices]
    compute = {dev: torch.cuda.current_stream(dev) for dev in devices}
    ready = {dev: _event(stream) for dev, stream in compute.items()}  # inputs and buffers

    def held(r, step):  # the (k, v) chunk rank r holds at `step`
        if step == 0:
            return ks[r], vs[r]
        return comm[r][step % 2, 0], comm[r][step % 2, 1]

    done: List[Optional[torch.cuda.Event]] = [None] * n  # latest step launch of each rank
    sent_prev: Optional[List[torch.cuda.Event]] = None  # hops of the previous step, by sender
    for step in range(n):
        sent = None
        if step + 1 < n:
            sent = []
            for r, dev in enumerate(devices):
                dst = (r + 1) % n
                stream = _copy_stream(dev)
                if step == 0:
                    stream.wait_event(ready[dev])
                    stream.wait_event(ready[devices[dst]])
                else:
                    stream.wait_event(sent_prev[r - 1])  # recv: the slot it sends from is full
                    stream.wait_event(done[dst])  # free: dst finished reading the slot
                    stream.wait_event(sent_prev[dst])  # free: dst finished sending from it
                k_src, v_src = held(r, step)
                slot = comm[dst][(step + 1) % 2]
                pairs = ([(slot[0], k_src), (slot[1], v_src)] if step == 0
                         else [(slot, comm[r][step % 2])])
                with torch.cuda.device(dev):
                    for dst_t, src_t in pairs:
                        err = lib.ca_ring_copy(dst_t.data_ptr(), devices[dst].index, src_t.data_ptr(),
                                               dev.index, src_t.numel() * 2, stream.cuda_stream)
                        _build.check(lib, err, "ca_ring_copy")
                sent.append(_event(stream))
        for group in _launch_groups(devices):
            dev = devices[group[0]]
            stream = compute[dev]
            if step > 0:
                for r in group:
                    stream.wait_event(sent_prev[r - 1])  # recv: this step's chunk arrived
            m = len(group)
            ptrs = ctypes.c_void_p * m
            chunks = [held(r, step) for r in group]
            with torch.cuda.device(dev):
                err = lib.ca_ring_flash_step_bf16(
                    ptrs(*[qs[r].data_ptr() for r in group]),
                    ptrs(*[k.data_ptr() for k, _ in chunks]),
                    ptrs(*[v.data_ptr() for _, v in chunks]),
                    ptrs(*[acc[r].data_ptr() if acc[r] is not None else None for r in group]),
                    ptrs(*[ml[r].data_ptr() if ml[r] is not None else None for r in group]),
                    ptrs(*[out[r].data_ptr() for r in group]),
                    (ctypes.c_int * m)(*group), m, b, h, lc, d, n, step,
                    txt_len, img_len, concept_len, int(cross), int(self_attention),
                    LOG2E / math.sqrt(d), stream.cuda_stream,
                )
            _build.check(lib, err, "ca_ring_flash_step_bf16 launch")
            ring_attention_rdma.step_launches += 1
            event = _event(stream)
            for r in group:
                done[r] = event
        if sent is not None:
            sent_prev = sent
    if sent_prev is not None:  # the last hops read each rank's buffers: done before they go
        for r, dev in enumerate(devices):
            compute[dev].wait_event(sent_prev[r])
    ring_attention_rdma.launches += 1
    return out


ring_attention_rdma.launches = 0
ring_attention_rdma.step_launches = 0


def make_ring_attention_rdma(mesh: Mesh, axis_name: str = "seq",
                             batch_axis: Optional[str] = None, head_axis: Optional[str] = None):
    """`ring_attention_rdma` as a callable on whole [B, H, S, D] tensors
    split over the mesh's `axis_name` (drop-in for `make_ring_attention`)."""
    return shard_over_ring(mesh, axis_name, ring_attention_rdma, batch_axis, head_axis)


def make_ring_concept_attention_rdma(
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
    """The masked variant as a callable on whole [B, H, S, D] tensors
    (drop-in for `make_ring_concept_attention`, the same fused
    [txt | img | concept | pad] contract), the "ring_rdma" backend."""

    def ring_fn(qs, ks, vs):
        return ring_attention_rdma(qs, ks, vs, masked=True, txt_len=txt_len, img_len=img_len,
                                   concept_len=concept_len, cross=cross,
                                   self_attention=self_attention)

    return shard_over_ring(mesh, axis_name, ring_fn, batch_axis, head_axis)
