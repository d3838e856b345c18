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

- each ring step is one launch of the step kernel (`ring_step`) per run of
  consecutive ranks that share a device (the rank is a grid axis, so a
  virtual ring on one card is one launch per step); the online-softmax state
  lives between steps in f32 buffers of each rank. `ring_instance` names the
  kernel for a head dim: the Hopper instance `csrc/ring_attention_sm90.cu`
  (TMA, an mbarrier ring and wgmma, K1's mainloop; head dims 64 and 128) or
  `csrc/ring_attention.cu` (mma.sync; head dim 32). Neither falls back to
  the other;
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
`ring_step_plain` is the function of one step launch in plain PyTorch, on
the state buffers' layout; folded over the N steps it is the ring.
`ring_attention_rdma.launches` counts the calls that launch the kernel,
`ring_attention_rdma.step_launches` the step launches (through `ring_step`),
`ring_attention_rdma.hopper_step_launches` those of the Hopper instance.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from conceptattention_torch.kernels import _build
from conceptattention_torch.kernels._autograd import refuse_autograd
from conceptattention_torch.parallel.mesh import Mesh
from conceptattention_torch.parallel.ring_attention import (
    LOG2E,
    Shards,
    _segment_mask,
    ring_attention,
    ring_concept_attention,
    shard_over_ring,
)

KERNEL_HEAD_DIMS = (32, 64, 128)
HOPPER_HEAD_DIMS = (64, 128)  # the flux (128) and CogVideoX (64) blocks
MAX_LOCAL_RANKS = 8  # ranks one launch covers (both step kernels)

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


def ring_instance(head_dim: int) -> str:
    """The K4 step kernel that takes a card call at this head dim: "hopper"
    (`csrc/ring_attention_sm90.cu`: 64, 128) or "mma_sync"
    (`csrc/ring_attention.cu`: 32)."""
    return "hopper" if head_dim in HOPPER_HEAD_DIMS else "mma_sync"


def ring_step_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]], my: int, step: int, ring_size: int,
    masked: bool = False, txt_len: int = 0, img_len: int = 0, concept_len: int = 0,
    cross: bool = True, self_attention: bool = True,
):
    """One step launch's function for rank `my` in plain PyTorch: q [B, H,
    Lc, D] and the K/V chunk it holds at `step` (the chunk of rank (my -
    step) mod N) folded into the running state (acc [B, H, Lc, D], ml [B,
    H, Lc, 2] f32: the row max of the scaled scores, -inf for a row that
    has seen nothing, and the row sum; None at step 0). The kernel's
    rounding points: f32 scores times log2(e)/sqrt(D), exp2, P rounded to
    v's dtype, f32 P.V. Returns the new (acc, ml), or at step N - 1 the
    output acc / l in v's dtype (0 where l == 0)."""
    b, h, lc, d = q.shape
    src = (my - step) % ring_size
    t, p, c = _kernel_segments(masked, ring_size, lc, txt_len, img_len, concept_len)
    iota = torch.arange(lc, device=q.device)
    allowed = _segment_mask(my * lc + iota, src * lc + iota, t, p, c, cross, self_attention)
    s = (q.float() @ k.float().transpose(-1, -2)) * (LOG2E / math.sqrt(d))
    s = s.masked_fill(~allowed, -math.inf)
    if state is None:
        m = torch.full((b, h, lc, 1), -math.inf, device=q.device)
        l, acc = torch.zeros_like(m), torch.zeros((b, h, lc, d), device=q.device)
    else:
        acc, ml = state
        m, l = ml[..., :1], ml[..., 1:]
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    ref = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)  # empty rows: exp2 -> 0
    p = torch.exp2(s - ref)
    alpha = torch.exp2(m - ref)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + p.to(v.dtype).float() @ v.float()
    if step == ring_size - 1:
        return (acc_new / torch.where(l_new == 0, torch.ones_like(l_new), l_new)).to(v.dtype)
    return acc_new, torch.cat([m_new, l_new], dim=-1)


def _kernel_segments(masked, ring_size, lc, txt_len, img_len, concept_len):
    """The segment lengths a step computes with: the unmasked ring is every
    position in txt (nothing masked but the chunk tails)."""
    if not masked:
        return ring_size * lc, 0, 0
    return txt_len, img_len, concept_len


def _library() -> ctypes.CDLL:
    """`csrc/ring_attention.cu`: the mma.sync step kernel and the hop."""
    lib = _build.load("ring_attention")
    if lib.ca_ring_flash_step_bf16.argtypes is None:
        lib.ca_ring_flash_step_bf16.argtypes = _STEP_ARGTYPES
        lib.ca_ring_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p]
        lib.ca_ring_flash_step_bf16.restype = lib.ca_ring_copy.restype = ctypes.c_int
    return lib


def _sm90_library() -> ctypes.CDLL:
    """`csrc/ring_attention_sm90.cu`: the Hopper step kernel."""
    lib = _build.load("ring_attention_sm90")
    if lib.ca_ring_step_sm90_bf16.argtypes is None:
        lib.ca_ring_step_sm90_bf16.argtypes = _STEP_ARGTYPES
        lib.ca_ring_step_sm90_bf16.restype = ctypes.c_int
    return lib


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_STEP_ARGTYPES = [_PTRS] * 6 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 12 + [
    ctypes.c_float, ctypes.c_void_p]
_STEP_ENTRIES = {"hopper": (_sm90_library, "ca_ring_step_sm90_bf16"),
                 "mma_sync": (_library, "ca_ring_flash_step_bf16")}


def _check_inputs(qs, ks, vs, txt_len, img_len, concept_len, ring_size=None):
    n = len(qs)
    if n < 1 or len(ks) != n or len(vs) != n:
        raise ValueError(f"one q, k and v shard per rank: {len(qs)} / {len(ks)} / {len(vs)}")
    shape = qs[0].shape
    if len(shape) != 4 or shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the ring kernel takes [B, H, Lc, D] shards with D in "
                         f"{KERNEL_HEAD_DIMS}, got {tuple(shape)}")
    tma = ring_instance(shape[-1]) == "hopper"
    for r, group in enumerate(zip(qs, ks, vs)):
        for name, t in zip("qkv", group):
            if t.dtype != torch.bfloat16:
                raise TypeError(f"the ring kernel takes bf16 shards, got {name}[{r}] {t.dtype}")
            if t.shape != shape or t.device != group[0].device or t.device.type != "cuda":
                raise ValueError(f"{name}[{r}] must be a CUDA [B, H, Lc, D] shard {tuple(shape)} "
                                 f"on q[{r}]'s device, got {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}[{r}] must be contiguous")
            if tma and t.data_ptr() % 16:
                raise ValueError(f"{name}[{r}] must be 16-byte aligned for TMA")
    total = (ring_size or n) * shape[2]
    if min(txt_len, img_len, concept_len) < 0 or txt_len + img_len + concept_len > total:
        raise ValueError(f"segments {txt_len}+{img_len}+{concept_len} exceed S={total}")


def _check_state(qs, accs, mls, outs, ranks, ring_size, step):
    """The buffers of one step launch: len(qs) ranks on q[0]'s device, the f32
    state read or written at this step, the bf16 output at the last."""
    m = len(qs)
    if not 1 <= m <= MAX_LOCAL_RANKS or len(ranks) != m or len(set(ranks)) != m:
        raise ValueError(f"one launch takes 1 to {MAX_LOCAL_RANKS} distinct ranks, got {ranks}")
    if not 0 <= step < ring_size or not all(0 <= r < ring_size for r in ranks):
        raise ValueError(f"step {step} and ranks {ranks} must lie in a ring of {ring_size}")
    b, h, lc, d = qs[0].shape
    need = {}
    if ring_size > 1:
        need.update(acc=(accs, torch.float32, (b, h, lc, d)), ml=(mls, torch.float32, (b, h, lc, 2)))
    if step == ring_size - 1:
        need["out"] = (outs, torch.bfloat16, (b, h, lc, d))
    for name, (bufs, dtype, shape) in need.items():
        for i, t in enumerate(bufs):
            if (t.dtype != dtype or t.shape != shape or t.device != qs[0].device
                    or not t.is_contiguous()):
                raise ValueError(f"{name}[{i}] must be a contiguous {dtype} {shape} on "
                                 f"{qs[0].device}")


def _launch_step(instance, qs, ks, vs, accs, mls, outs, ranks, ring_size, step, segments):
    """One launch of the step kernel `instance` on q[0]'s device and current
    stream, uncounted (`ring_step` counts)."""
    make_lib, entry = _STEP_ENTRIES[instance]
    lib = make_lib()
    m = len(qs)
    b, h, lc, d = qs[0].shape
    ptrs = ctypes.c_void_p * m

    def addresses(ts):
        return ptrs(*[t.data_ptr() if t is not None else None for t in ts])

    dev = qs[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            addresses(qs), addresses(ks), addresses(vs), addresses(accs), addresses(mls),
            addresses(outs), (ctypes.c_int * m)(*ranks), m, b, h, lc, d, ring_size, step,
            *segments[:3], int(segments[3]), int(segments[4]), LOG2E / math.sqrt(d),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, f"{entry} launch")


def _counted_step(qs, ks, vs, accs, mls, outs, ranks, ring_size, step, segments):
    instance = ring_instance(qs[0].shape[-1])
    _launch_step(instance, qs, ks, vs, accs, mls, outs, ranks, ring_size, step, segments)
    ring_attention_rdma.step_launches += 1
    if instance == "hopper":
        ring_attention_rdma.hopper_step_launches += 1


def ring_step(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    accs: Sequence[Optional[torch.Tensor]],
    mls: Sequence[Optional[torch.Tensor]],
    outs: Sequence[Optional[torch.Tensor]],
    ranks: Sequence[int],
    ring_size: int,
    step: int,
    *,
    masked: bool = False,
    txt_len: int = 0,
    img_len: int = 0,
    concept_len: int = 0,
    cross: bool = True,
    self_attention: bool = True,
) -> None:
    """One ring step for the ranks `ranks`, all on one device, on the
    caller's buffers: rank ranks[i] holds the query shard qs[i] and the K/V
    chunk ks[i], vs[i] of rank (ranks[i] - step) mod N; its state accs[i]
    [B, H, Lc, D] and mls[i] [B, H, Lc, 2] (f32) is read unless step == 0
    and written unless step == N - 1, when outs[i] (bf16) gets the output
    (`ring_step_plain`'s contract). On CUDA tensors one launch of the step
    kernel `ring_instance` names, counted; on CPU tensors
    `ring_step_plain` into the same buffers."""
    refuse_autograd("ring_step", qs, ks, vs, accs, mls, outs)
    segments = dict(masked=masked, txt_len=txt_len, img_len=img_len, concept_len=concept_len,
                    cross=cross, self_attention=self_attention)
    if all(q.device.type == "cpu" for q in qs):
        for i, r in enumerate(ranks):
            state = None if step == 0 else (accs[i], mls[i])
            res = ring_step_plain(qs[i], ks[i], vs[i], state, r, step, ring_size, **segments)
            if step == ring_size - 1:
                outs[i].copy_(res)
            else:
                accs[i].copy_(res[0])
                mls[i].copy_(res[1])
        return
    _check_inputs(qs, ks, vs, txt_len, img_len, concept_len, ring_size)
    _check_state(qs, accs, mls, outs, ranks, ring_size, step)
    lc = qs[0].shape[2]
    _counted_step(qs, ks, vs, accs, mls, outs, ranks, ring_size, step,
                  (*_kernel_segments(masked, ring_size, lc, txt_len, img_len, concept_len),
                   cross, self_attention))


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


def _run_ring(qs: Shards, ks: Shards, vs: Shards, segments: Tuple, step_fn: Callable) -> Shards:
    """The ring on the card for checked shards: each rank's state buffers
    and comm slots, the hops on copy streams, one `step_fn(qs, ks, vs, accs,
    mls, outs, ranks, N, step, segments)` per launch group and step, all
    ordered by events. `segments` are the kernel's (txt, img, concept,
    cross, self_attention)."""
    n = len(qs)
    b, h, lc, d = qs[0].shape
    devices = [q.device for q in qs]
    lib = _library()  # the hop

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
            chunks = [held(r, step) for r in group]
            step_fn([qs[r] for r in group], [k for k, _ in chunks], [v for _, v in chunks],
                    [acc[r] for r in group], [ml[r] for r in group], [out[r] for r in group],
                    group, n, step, segments)
            event = _event(stream)
            for r in group:
                done[r] = event
        if sent is not None:
            sent_prev = sent
    if sent_prev is not None:  # the last hops read each rank's buffers: done before they go
        for r, dev in enumerate(devices):
            compute[dev].wait_event(sent_prev[r])
    return out


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
    refuse_autograd("ring_attention_rdma", qs, ks, vs)
    if all(q.device.type == "cpu" for q in qs):
        return ring_attention_rdma_plain(qs, ks, vs, masked, txt_len, img_len, concept_len,
                                         cross, self_attention)
    _check_inputs(qs, ks, vs, txt_len, img_len, concept_len)
    segments = (*_kernel_segments(masked, len(qs), qs[0].shape[2], txt_len, img_len, concept_len),
                cross, self_attention)
    out = _run_ring(qs, ks, vs, segments, _counted_step)
    ring_attention_rdma.launches += 1
    return out


ring_attention_rdma.launches = 0
ring_attention_rdma.step_launches = 0
ring_attention_rdma.hopper_step_launches = 0


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
