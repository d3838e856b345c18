"""Fused dual-pass concept flash attention: CUDA kernel, plain version, wrapper.

Counterpart of the JAX package's `kernels/flash_saliency.py`. One
segment-masked online-softmax sweep over the fused sequence
S = [txt | img | concept | pad]:

    q in txt|img   ->  k in txt|img          (the joint attention; concepts
                                               stay invisible to generation)
    q in concept   ->  k in img | concept    (the concept pass, with its own
                                               softmax denominator)

Rows that see nothing (padding, or concepts with both ablations off) come out
as exact zeros. Interleaved-pair RoPE is applied inside the kernel from the
expanded tables of `expand_rope_tables`.

`fused_concept_flash_attention` (K1) runs `fused_concept_flash_attention_plain`
for a CPU tensor and, for a CUDA tensor, launches the instance that
`flash_instance` names for its head dim: `fused_concept_flash_attention_hopper`
(head dims 64, 128 and 512: `csrc/flash_saliency_sm90.cu`, a RoPE pre-pass,
then TMA, an mbarrier ring and wgmma) or `csrc/flash_saliency.cu` (head dim
32: mma.sync). It never falls back from one to another. `fused_concept_flash_attention_paired`
(K3) is the same function for head dim 64, an even head count and RoPE,
launched as the RoPE pre-pass and the Hopper kernel's instance that walks the
two heads of a pair through one block (`csrc/flash_saliency_sm90.cu`,
`ca_flash_saliency_paired_sm90_bf16`); `csrc/flash_saliency.cu` keeps its
mma.sync two-heads-per-block instance only as a yardstick, never called
here. `joint_concept_attention_fused` takes K3 for such inputs when
`PAIR_HEADS` is set (off by default, as the JAX package's `_PAIR_HEADS`).
`fused_concept_flash_attention_int8` (K1b, what
`int8_qk=True` selects) is the same function with per-row int8 q and k and
int8 x int8 -> int32 scores: `csrc/flash_saliency_int8.cu`'s pre-pass
quantizes every row once, then the instance that `int8_instance` names for
the head dim runs the attention: `fused_concept_flash_attention_int8_hopper`
(head dim 128: `csrc/flash_saliency_int8_sm90.cu`, TMA, an mbarrier ring and
s8 wgmma on K1's mainloop) or `csrc/flash_saliency_int8.cu`'s mma.sync
kernel (head dims 32 and 64); it never falls back from one to another and
never takes K3. Each wrapper's `launches` attribute counts its calls that
launch its kernels.

At head dim 128 the Hopper kernel has several compiled instances
(`FLASH_D128_INSTANCES`). Which one a call takes is chosen at run time, as
the JAX kernel chooses its tiles (`_auto_tiles`): the overlay
`_TUNED_TILES`, keyed on the call's workload (`tile_key`: head dim, S,
B x H, the segments and the mask mode) and filled by `kernels/autotune.py`
(its sweep, or its per-card cache read once, lazily, at the first card
call), else the head dim's default (`default_instance`: at 128 the
register-reallocating overlap, instance 3, at every S).
`fused_concept_flash_attention_hopper.instance_launches` counts the launches
of each.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from conceptattention_torch.kernels import _build
from conceptattention_torch.kernels._autograd import refuse_autograd
from conceptattention_torch.ops.attention import merge_heads
from conceptattention_torch.ops.quant import INV127

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # log2(e): the softmax runs in the exp2 domain
KERNEL_HEAD_DIMS = (32, 64, 128, 512)
# The flux DiT blocks (128), the CogVideoX blocks (64) and the flux VAE's
# mid-attention (512); head dim 32 stays on mma.sync.
HOPPER_HEAD_DIMS = (64, 128, 512)
INT8_HEAD_DIMS = (32, 64, 128)  # K1b's instances; the VAE's D=512 never takes int8
INT8_HOPPER_HEAD_DIMS = (128,)  # the flux DiT blocks; 32 and 64 stay on mma.sync
PAIRED_HEAD_DIM = 64
# The compiled instances <D, DC, HK, STAGES, schedule, heads a block> of the
# Hopper kernel at head dim 128 (`ca_flash_saliency_sm90_bf16_instance`), by
# index; every other head dim has instance 0 alone.
FLASH_D128_INSTANCES = (
    "<128, 128, 128, 2, in order, 1>",
    "<128, 128, 128, 2, pingpong, 1>",
    "<128, 128, 64, 4, in order, 1>",
    "<128, 128, 192, 2, overlap wide, 1>",
)
# The instance a D=128 call takes without a tuned entry: the overlap on the
# producer's registers (setmaxnreg), faster than 0-2 from S=1286 to S=67.5k.
D128_DEFAULT_INSTANCE = 3
# {tile_key(...): instance}: the run-time overlay that `kernels/autotune.py`
# fills (`register_tuned_tiles`, `load_tile_cache`).
_TUNED_TILES: Dict[Tuple[int, ...], int] = {}
_tile_cache_loaded = False
# Route d=64 attention with an even head count through K3 (the head-paired
# instance) instead of K1; read at call time.
PAIR_HEADS = False


def _pair_swap(x: torch.Tensor) -> torch.Tensor:
    """swap(x)[2i] = x[2i+1], swap(x)[2i+1] = x[2i]."""
    return x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)


def segment_mask(
    seq_len: int, txt_len: int, img_len: int, concept_len: int,
    cross: bool, self_attention: bool, device=None,
) -> torch.Tensor:
    """[S, S] bool: may query i attend key j."""
    idx = torch.arange(seq_len, device=device)
    qi, kj = idx[:, None], idx[None, :]
    joint_end = txt_len + img_len
    concept_end = joint_end + concept_len
    allowed = (qi < joint_end) & (kj < joint_end)
    concept_keys = torch.zeros_like(kj, dtype=torch.bool)
    if cross:
        concept_keys = concept_keys | ((kj >= txt_len) & (kj < joint_end))
    if self_attention:
        concept_keys = concept_keys | ((kj >= joint_end) & (kj < concept_end))
    return allowed | ((qi >= joint_end) & (qi < concept_end) & concept_keys)


def _quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of f32 rows: s = max|x| * f32(1/127) (what XLA
    makes of the JAX kernel's `max|x| / 127`), x8 = round_half_even(x /
    max(s, 1e-9)). Returns (x8, s[..., S]); s is the unguarded scale, so a
    zero row scores 0."""
    s = x.abs().amax(dim=-1, keepdim=True) * INV127
    x8 = torch.round(x / torch.clamp(s, min=1e-9)).to(torch.int8)
    return x8, s[..., 0]


def quantize_qk_rows_plain(q, k, rope_cos=None, rope_sin=None):
    """K1b's pre-pass in plain PyTorch: (q8, qs, k8, ks), int8 [B, H, S, D]
    rows and f32 [B, H, S] scales. With tables, q is roped and pre-scaled by
    log2(e)/sqrt(D) in f32 and quantized from f32; k is roped, rounded to
    k's dtype, and quantized. Without tables both are quantized as given."""
    qf, kf = q.float(), k.float()
    if rope_cos is not None:
        scale = LOG2E / math.sqrt(q.shape[-1])
        cos, sin = rope_cos[:, None], rope_sin[:, None]  # [B, 1, S, D]
        qf = (qf * cos + _pair_swap(qf) * sin) * scale
        kf = (kf * cos + _pair_swap(kf) * sin).to(k.dtype).float()
    q8, qs = _quantize_rows_plain(qf)
    k8, ks = _quantize_rows_plain(kf)
    return q8, qs, k8, ks


def rope_qk_rows_plain(q, k, rope_cos, rope_sin):
    """The Hopper instance's pre-pass in plain PyTorch: (q', k') [B, H, S, D]
    with q' = rope(q) * log2(e)/sqrt(D) in f32 rounded to q's dtype and k' =
    rope(k) in f32 rounded to k's dtype, over the expanded [B, S, D] tables.
    The attention of q' and k' without tables at score scale 1 is the
    attention of q and k with them."""
    scale = LOG2E / math.sqrt(q.shape[-1])
    cos, sin = rope_cos[:, None], rope_sin[:, None]  # [B, 1, S, D]
    qf, kf = q.float(), k.float()
    return (((qf * cos + _pair_swap(qf) * sin) * scale).to(q.dtype),
            (kf * cos + _pair_swap(kf) * sin).to(k.dtype))


def scaled_concept_attention_plain(q, k, v, txt_len, img_len, concept_len, cross=True,
                                   self_attention=True, score_scale=1.0):
    """The segment-masked exp2-softmax attention of q and k as given: f32
    scores times `score_scale`, P rounded to v's dtype, f32 P.V; rows that
    see nothing come out as zeros."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * score_scale
    return _masked_softmax_pv(scores, v, txt_len, img_len, concept_len, cross, self_attention)


def _masked_softmax_pv(scores, v, txt_len, img_len, concept_len, cross, self_attention):
    allowed = segment_mask(
        scores.shape[-1], txt_len, img_len, concept_len, cross, self_attention, scores.device
    )
    scores = scores.masked_fill(~allowed, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m).masked_fill(~allowed, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(v.dtype)


def fused_concept_flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    int8_qk: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same rounding points:
    roped q pre-scaled in f32 and rounded to q's dtype, roped k rounded,
    f32 scores, exp2 softmax, P rounded to v's dtype, f32 P.V. With
    `int8_qk` (K1b) the scores are int8 x int8 sums of the pre-pass's rows
    times their row scales (and log2(e)/sqrt(D) without tables); the integer
    sums are exact in an f32 product, whose partial sums stay below 2^24
    for D <= 512."""
    segments = (txt_len, img_len, concept_len, cross, self_attention)
    if not int8_qk:
        if rope_cos is not None:
            return scaled_concept_attention_plain(
                *rope_qk_rows_plain(q, k, rope_cos, rope_sin), v, *segments)
        return scaled_concept_attention_plain(
            q, k, v, *segments, score_scale=LOG2E / math.sqrt(q.shape[-1]))
    q8, qs, k8, ks = quantize_qk_rows_plain(q, k, rope_cos, rope_sin)
    s32 = q8.float() @ k8.float().transpose(-1, -2)
    scores = s32 * (qs[..., :, None] * ks[..., None, :])
    if rope_cos is None:
        scores = scores * (LOG2E / math.sqrt(q.shape[-1]))
    return _masked_softmax_pv(scores, v, *segments)


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_saliency")
    for fn in (lib.ca_flash_saliency_bf16, lib.ca_flash_saliency_paired_bf16):
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
    return lib


def _check_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_saliency kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, S, D] shape: {q.shape} {k.shape} {v.shape}")
    b, _, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_saliency kernel supports head dims {KERNEL_HEAD_DIMS}, got {d}")
    if min(txt_len, img_len, concept_len) < 0 or txt_len + img_len + concept_len > s:
        raise ValueError(f"segments {txt_len}+{img_len}+{concept_len} exceed S={s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("pass both rope tables or neither")
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if t.dtype != torch.float32 or t.shape != (b, s, d):
                raise ValueError(f"{name} must be f32 [{b}, {s}, {d}], got {t.dtype} {tuple(t.shape)}")
            if t.device != q.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {q.device}")


def fused_concept_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    int8_qk: bool = False,
) -> torch.Tensor:
    """Fused dual-pass attention over S = [txt | img | concept | pad].

    q/k/v: [B, H, S, D], unroped when tables are given. concept_len is the
    number of REAL concept rows; rows past txt+img+concept are padding and
    come out as zeros. rope_cos/rope_sin: optional expanded [B, S, D] f32
    tables. `int8_qk` takes K1b (`fused_concept_flash_attention_int8`).
    Returns [B, H, S, D] in v's dtype.
    """
    refuse_autograd("fused_concept_flash_attention", q, k, v, rope_cos, rope_sin)
    if int8_qk:
        return fused_concept_flash_attention_int8(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention, rope_cos, rope_sin)
    if q.device.type == "cpu":
        return fused_concept_flash_attention_plain(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention,
            rope_cos, rope_sin,
        )
    _check_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin)
    if flash_instance(q.shape[-1]) == "hopper":
        out = fused_concept_flash_attention_hopper(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention, rope_cos, rope_sin)
    else:
        out = _launch("ca_flash_saliency_bf16", q, k, v, txt_len, img_len, concept_len,
                      cross, self_attention, rope_cos, rope_sin)
    fused_concept_flash_attention.launches += 1
    return out


fused_concept_flash_attention.launches = 0


def flash_instance(head_dim: int) -> str:
    """The K1 kernel that takes a card call at this head dim: "hopper"
    (`csrc/flash_saliency_sm90.cu`: 64, 128, 512) or "mma_sync"
    (`csrc/flash_saliency.cu`: 32)."""
    return "hopper" if head_dim in HOPPER_HEAD_DIMS else "mma_sync"


def hopper_instances(head_dim: int) -> Tuple[int, ...]:
    """The indices of the Hopper kernel's compiled instances at this head
    dim: all of `FLASH_D128_INSTANCES` at 128, instance 0 at 64 and 512."""
    if head_dim == 128:
        return tuple(range(len(FLASH_D128_INSTANCES)))
    return (0,) if head_dim in HOPPER_HEAD_DIMS else ()


def default_instance(head_dim: int) -> int:
    """The instance a call at this head dim takes without a tuned overlay
    entry: `D128_DEFAULT_INSTANCE` at 128, the only one (0) elsewhere."""
    return D128_DEFAULT_INSTANCE if head_dim == 128 else 0


def tile_key(head_dim: int, seq_len: int, batch_heads: int, txt_len: int, img_len: int,
             concept_len: int, cross: bool = True, self_attention: bool = True) -> Tuple[int, ...]:
    """The overlay's key: everything that sets a call's work and block
    count. A winner timed on one workload steers only calls of that one."""
    return tuple(int(x) for x in (head_dim, seq_len, batch_heads, txt_len, img_len, concept_len,
                                  cross, self_attention))


def _auto_instance(*key) -> int:
    """The instance a call of `tile_key(*key)` takes: the tuned overlay's
    entry, else the head dim's default (`default_instance`). The first call
    reads the card's tile cache into the overlay (`autotune.load_tile_cache`;
    a missing or corrupt file leaves it empty)."""
    global _tile_cache_loaded
    if not _tile_cache_loaded:
        _tile_cache_loaded = True  # one attempt; no cache is the common case
        from conceptattention_torch.kernels import autotune

        autotune.load_tile_cache()
    return _TUNED_TILES.get(tile_key(*key), default_instance(key[0]))


def _sm90_library() -> ctypes.CDLL:
    lib = _build.load("flash_saliency_sm90")
    if lib.ca_flash_saliency_sm90_bf16.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ca_rope_qk_rows_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
        for fn in (lib.ca_flash_saliency_sm90_bf16, lib.ca_flash_saliency_paired_sm90_bf16):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
            fn.restype = i
        lib.ca_flash_saliency_sm90_bf16_instance.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, p]
        lib.ca_flash_saliency_sm90_bf16_instance.restype = i
        lib.ca_rope_qk_rows_bf16.restype = i
    return lib


def rope_qk_rows_cuda(q, k, rope_cos, rope_sin):
    """The Hopper instance's pre-pass kernel: `rope_qk_rows_plain`'s (q', k')
    for inputs that passed `_check_inputs`, head dims 64, 128 and 512."""
    b, h, s, d = q.shape
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    lib = _sm90_library()
    with torch.cuda.device(q.device):
        err = lib.ca_rope_qk_rows_bf16(
            q.data_ptr(), k.data_ptr(), rope_cos.data_ptr(), rope_sin.data_ptr(),
            q_out.data_ptr(), k_out.data_ptr(), b, h, s, d, LOG2E / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "ca_rope_qk_rows_bf16 launch")
    return q_out, k_out


def fused_concept_flash_attention_hopper(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    instance: Optional[int] = None,
) -> torch.Tensor:
    """`fused_concept_flash_attention` through `csrc/flash_saliency_sm90.cu`,
    head dims 64, 128 and 512: with tables, the pre-pass ropes and rounds
    every q and k row once (`rope_qk_rows_cuda`) and the main kernel scores
    them at scale 1; without, it scores q and k as given at
    log2(e)/sqrt(D). `instance` picks one of `hopper_instances(D)`; None
    takes the tuned overlay's, else the default (`_auto_instance`). An index outside
    them raises ValueError before any launch, on the CPU too."""
    refuse_autograd("fused_concept_flash_attention_hopper", q, k, v, rope_cos, rope_sin)
    d = q.shape[-1]
    if instance is not None and instance not in hopper_instances(d):
        raise ValueError(f"head dim {d} has Hopper instances {hopper_instances(d)}, "
                         f"not {instance}")
    if q.device.type == "cpu":
        return fused_concept_flash_attention_plain(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention, rope_cos, rope_sin)
    _check_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin)
    if flash_instance(d) != "hopper":
        raise ValueError(f"the Hopper flash kernel takes head dims {HOPPER_HEAD_DIMS}, got {d}")
    if instance is None:
        instance = _auto_instance(d, q.shape[2], q.shape[0] * q.shape[1], txt_len, img_len,
                                  concept_len, cross, self_attention)
    out = _launch_sm90("ca_flash_saliency_sm90_bf16_instance", q, k, v, txt_len, img_len,
                       concept_len, cross, self_attention, rope_cos, rope_sin, instance)
    fused_concept_flash_attention_hopper.launches += 1
    if d == 128:
        fused_concept_flash_attention_hopper.instance_launches[instance] += 1
    return out


def _launch_sm90(entry, q, k, v, txt_len, img_len, concept_len, cross, self_attention,
                 rope_cos, rope_sin, *extra):
    """The RoPE pre-pass (with tables) and one launch of the Hopper kernel's
    `entry` on checked inputs, uncounted; `extra` are the entry's arguments
    before the stream (the instance index of
    `ca_flash_saliency_sm90_bf16_instance`)."""
    b, h, s, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):  # TMA, and the pre-pass's 16-byte loads
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")
    score_mul = LOG2E / math.sqrt(d)
    if rope_cos is not None:
        q, k = rope_qk_rows_cuda(q, k, rope_cos, rope_sin)
        score_mul = 1.0
    out = torch.empty_like(v)
    lib = _sm90_library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
            txt_len, img_len, concept_len, int(cross), int(self_attention), score_mul, *extra,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, f"{entry} launch")
    return out


fused_concept_flash_attention_hopper.launches = 0
# launches of each D=128 instance, by index of FLASH_D128_INSTANCES
fused_concept_flash_attention_hopper.instance_launches = [0] * len(FLASH_D128_INSTANCES)


def _launch(entry, q, k, v, txt_len, img_len, concept_len, cross, self_attention,
            rope_cos, rope_sin):
    b, h, s, d = q.shape
    out = torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rope_cos.data_ptr() if rope_cos is not None else None,
            rope_sin.data_ptr() if rope_sin is not None else None,
            out.data_ptr(), b, h, s, d, txt_len, img_len, concept_len,
            int(cross), int(self_attention), LOG2E / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, f"{entry} launch")
    return out


def _int8_library() -> ctypes.CDLL:
    lib = _build.load("flash_saliency_int8")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if lib.ca_flash_saliency_int8.argtypes is None:
        lib.ca_flash_saliency_int8_prepass.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.ca_flash_saliency_int8.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.ca_flash_saliency_int8_prepass.restype = lib.ca_flash_saliency_int8.restype = i
    return lib


def _int8_sm90_library() -> ctypes.CDLL:
    lib = _build.load("flash_saliency_int8_sm90")
    if lib.ca_flash_saliency_int8_sm90.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ca_flash_saliency_int8_sm90.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f,
                                                    p]
        lib.ca_flash_saliency_int8_sm90.restype = i
    return lib


def quantize_qk_rows_cuda(q, k, rope_cos=None, rope_sin=None):
    """K1b's pre-pass kernel on the card: `quantize_qk_rows_plain`'s
    (q8, qs, k8, ks) for inputs that passed `_check_inputs`."""
    b, h, s, d = q.shape
    q8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    k8 = torch.empty_like(q8)
    qs = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ks = torch.empty_like(qs)
    lib = _int8_library()
    with torch.cuda.device(q.device):
        err = lib.ca_flash_saliency_int8_prepass(
            q.data_ptr(), k.data_ptr(),
            rope_cos.data_ptr() if rope_cos is not None else None,
            rope_sin.data_ptr() if rope_sin is not None else None,
            q8.data_ptr(), k8.data_ptr(), qs.data_ptr(), ks.data_ptr(), b, h, s, d,
            LOG2E / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "ca_flash_saliency_int8_prepass launch")
    return q8, qs, k8, ks


def int8_instance(head_dim: int) -> str:
    """The K1b kernel that takes a card call at this head dim: "hopper"
    (`csrc/flash_saliency_int8_sm90.cu`: 128) or "mma_sync"
    (`csrc/flash_saliency_int8.cu`: 32, 64)."""
    return "hopper" if head_dim in INT8_HOPPER_HEAD_DIMS else "mma_sync"


def _check_int8_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin):
    """`_check_inputs`, K1b's head dims, and the 16-byte alignment that the
    pre-pass's loads, the mma.sync kernel's copies and TMA all need."""
    _check_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin)
    if q.shape[-1] not in INT8_HEAD_DIMS:
        raise ValueError(f"the int8 kernel supports head dims {INT8_HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_concept_flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1b: `fused_concept_flash_attention` with per-row int8 q and k and
    int8 x int8 -> int32 scores (the JAX kernel's `int8_qk=True`). On the
    card, the pre-pass kernel quantizes every row once, then the instance
    that `int8_instance` names runs the masked online softmax: the Hopper
    kernel at head dim 128, the mma.sync kernel at 32 and 64."""
    refuse_autograd("fused_concept_flash_attention_int8", q, k, v, rope_cos, rope_sin)
    if q.device.type == "cpu":
        return fused_concept_flash_attention_plain(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention,
            rope_cos, rope_sin, int8_qk=True,
        )
    _check_int8_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin)
    if int8_instance(q.shape[-1]) == "hopper":
        out = fused_concept_flash_attention_int8_hopper(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention, rope_cos, rope_sin)
    else:
        out = _launch_int8("ca_flash_saliency_int8", q, k, v, txt_len, img_len, concept_len,
                           cross, self_attention, rope_cos, rope_sin)
    fused_concept_flash_attention_int8.launches += 1
    return out


fused_concept_flash_attention_int8.launches = 0


def fused_concept_flash_attention_int8_hopper(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1b through `csrc/flash_saliency_int8_sm90.cu`, head dim 128: the
    pre-pass (`quantize_qk_rows_cuda`), then the Hopper kernel on the int8
    rows and their scales."""
    refuse_autograd("fused_concept_flash_attention_int8_hopper", q, k, v, rope_cos, rope_sin)
    if q.device.type == "cpu":
        return fused_concept_flash_attention_plain(
            q, k, v, txt_len, img_len, concept_len, cross, self_attention,
            rope_cos, rope_sin, int8_qk=True,
        )
    _check_int8_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin)
    if int8_instance(q.shape[-1]) != "hopper":
        raise ValueError(f"the Hopper int8 kernel takes head dims {INT8_HOPPER_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    out = _launch_int8("ca_flash_saliency_int8_sm90", q, k, v, txt_len, img_len, concept_len,
                       cross, self_attention, rope_cos, rope_sin)
    fused_concept_flash_attention_int8_hopper.launches += 1
    return out


fused_concept_flash_attention_int8_hopper.launches = 0


def _launch_int8(entry, q, k, v, txt_len, img_len, concept_len, cross, self_attention,
                 rope_cos, rope_sin):
    """The pre-pass and one launch of K1b's main kernel `entry` (the
    mma.sync "ca_flash_saliency_int8" or the Hopper
    "ca_flash_saliency_int8_sm90") on checked inputs, uncounted."""
    b, h, s, d = q.shape
    q8, qs, k8, ks = quantize_qk_rows_cuda(q, k, rope_cos, rope_sin)
    out = torch.empty_like(v)
    lib = _int8_sm90_library() if entry == "ca_flash_saliency_int8_sm90" else _int8_library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q8.data_ptr(), k8.data_ptr(), qs.data_ptr(), ks.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, s, d, txt_len, img_len, concept_len, int(cross),
            int(self_attention), 1.0 if rope_cos is not None else LOG2E / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, f"{entry} launch")
    return out


def _check_paired_contract(q, rope_cos, rope_sin):
    """K3's contract beyond K1's: head dim 64, an even head count, RoPE."""
    if q.dim() != 4 or q.shape[-1] != PAIRED_HEAD_DIM or q.shape[1] % 2:
        raise ValueError(
            f"the paired kernel takes [B, H, S, {PAIRED_HEAD_DIM}] with H even, got {tuple(q.shape)}"
        )
    if rope_cos is None or rope_sin is None:
        raise ValueError("the paired kernel needs both RoPE tables")


def fused_concept_flash_attention_paired_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
) -> torch.Tensor:
    """K3's function in plain PyTorch: K1's, restricted to its contract (the
    two heads of a pair are independent attentions over shared positions)."""
    _check_paired_contract(q, rope_cos, rope_sin)
    return fused_concept_flash_attention_plain(
        q, k, v, txt_len, img_len, concept_len, cross, self_attention, rope_cos, rope_sin
    )


def fused_concept_flash_attention_paired(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    txt_len: int,
    img_len: int,
    concept_len: int,
    cross: bool = True,
    self_attention: bool = True,
) -> torch.Tensor:
    """`fused_concept_flash_attention` for head dim 64, an even head count and
    RoPE tables, the two heads of a pair in one kernel block (counterpart of
    the JAX package's `fused_concept_flash_attention_paired`): on the card the
    RoPE pre-pass, then the Hopper kernel's paired instance. Returns [B, H,
    S, 64] with rows that see nothing zero."""
    refuse_autograd("fused_concept_flash_attention_paired", q, k, v, rope_cos, rope_sin)
    if q.device.type == "cpu":
        return fused_concept_flash_attention_paired_plain(
            q, k, v, rope_cos, rope_sin, txt_len, img_len, concept_len, cross, self_attention
        )
    _check_paired_contract(q, rope_cos, rope_sin)
    _check_inputs(q, k, v, txt_len, img_len, concept_len, rope_cos, rope_sin)
    out = _launch_sm90("ca_flash_saliency_paired_sm90_bf16", q, k, v, txt_len, img_len,
                       concept_len, cross, self_attention, rope_cos, rope_sin)
    fused_concept_flash_attention_paired.launches += 1
    return out


fused_concept_flash_attention_paired.launches = 0


def expand_rope_tables(
    segments: Sequence[Tuple[torch.Tensor, torch.Tensor]], total_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's expanded [B, total_len, D] f32 tables from per-segment
    (cos, sin) pairs of shape [B, 1, N, D/2] (as `ops.rope.embed_nd` builds
    them): cos[2i] = cos[2i+1] = c_i, sin[2i] = -s_i, sin[2i+1] = +s_i.
    Rows past the segments get the identity rotation. Tables are per batch
    row, so per-sample position ids rope correctly."""
    cos_parts, sin_parts = [], []
    b = segments[0][0].shape[0]
    n_done = 0
    for c, s in segments:
        c0, s0 = c[:, 0].float(), s[:, 0].float()  # [B, N, D/2]
        cos_parts.append(c0.repeat_interleave(2, dim=-1))
        sin_parts.append(torch.stack([-s0, s0], dim=-1).reshape(b, s0.shape[1], -1))
        n_done += c0.shape[1]
    d = cos_parts[0].shape[-1]
    if n_done < total_len:
        device = cos_parts[0].device
        cos_parts.append(torch.ones((b, total_len - n_done, d), device=device))
        sin_parts.append(torch.zeros((b, total_len - n_done, d), device=device))
    return torch.cat(cos_parts, dim=1), torch.cat(sin_parts, dim=1)


def joint_concept_attention_fused(
    txt_qkv, img_qkv, concept_qkv, pe, concept_pe,
    cross: bool = True, self_attention: bool = True, int8_qk: bool = False,
):
    """`ops.attention.joint_concept_attention` through ONE kernel call
    (counterpart of `pallas_joint_concept_attention`): K1b with `int8_qk`,
    else K3 for head dim 64 with an even head count when `PAIR_HEADS` is
    set, else K1. Concepts are
    appended unpadded; the kernel masks the ragged tail. Returns (txt_attn, img_attn,
    concept_attn, extras) with merged-head [B, L, H*D] outputs and the
    pre-RoPE q/k/v plus head-form outputs in extras."""
    txt_q, txt_k, txt_v = txt_qkv
    img_q, img_k, img_v = img_qkv
    t, p = txt_q.shape[2], img_q.shape[2]
    cos, sin = pe
    seqs = [txt_qkv, img_qkv]
    segments = [(cos, sin)]
    c_real = 0
    if concept_qkv is not None:
        c_real = concept_qkv[0].shape[2]
        ccos, csin = concept_pe
        seqs.append(concept_qkv)
        segments.append((ccos[:, :, :c_real], csin[:, :, :c_real]))
    q, k, v = (torch.cat([seq[i] for seq in seqs], dim=2) for i in range(3))
    rope_cos, rope_sin = expand_rope_tables(segments, q.shape[2])
    h, d = q.shape[1], q.shape[3]
    if PAIR_HEADS and d == PAIRED_HEAD_DIM and h % 2 == 0 and not int8_qk:
        out = fused_concept_flash_attention_paired(
            q, k, v, rope_cos, rope_sin, txt_len=t, img_len=p, concept_len=c_real,
            cross=cross, self_attention=self_attention,
        )
    else:
        out = fused_concept_flash_attention(
            q, k, v, txt_len=t, img_len=p, concept_len=c_real,
            cross=cross, self_attention=self_attention,
            rope_cos=rope_cos, rope_sin=rope_sin, int8_qk=int8_qk,
        )
    txt_attn = merge_heads(out[:, :, :t])
    img_out_h = out[:, :, t : t + p]
    img_attn = merge_heads(img_out_h)
    if concept_qkv is None:
        return txt_attn, img_attn, None, {}
    if not cross and not self_attention:
        # "Neither" ablation: the concept stream passes its values through.
        concept_out_h = concept_qkv[2]
    else:
        concept_out_h = out[:, :, t + p : t + p + c_real]
    extras = {
        "concept_q": concept_qkv[0],
        "concept_k": concept_qkv[1],
        "img_q": img_q,
        "concept_v": concept_qkv[2],
        "img_v": img_v,
        "concept_out_h": concept_out_h,
        "img_out_h": img_out_h,
    }
    return txt_attn, img_attn, merge_heads(concept_out_h), extras
