"""On-device instance autotuner for the fused flash-saliency kernel (K1).

Counterpart of the JAX package's `kernels/autotune.py`, which sweeps the
Pallas kernel's (block_q, block_k) for a sequence length. The Hopper
kernel's tile shape is fixed at compile time (128 query rows a block, the
template <D, DC, HK, STAGES, schedule, heads>), so here a candidate is one
of its compiled instances (`flash_saliency.FLASH_D128_INSTANCES` at head
dim 128; every other head dim has one). This module times each candidate
with `utils/profiling.loop_rate`, keeps the fastest in the run-time overlay
that `flash_saliency._auto_instance` reads and persists it in a JSON cache
for each card kind, which the first card call reads back. The overlay is
keyed on the probe's whole workload (`flash_saliency.tile_key`: head dim,
S, B x H, the txt / img / concept segments and the mask mode), because
the choice follows how many blocks a call launches and how many key tiles
its rows walk: a winner steers only calls of the workload it was timed on.
The probe defaults to JAX's, pure self-attention (`txt_len=S`), which is
the flux single blocks' call; `segments=` times the double blocks' (txt,
img, concept) layout. It runs the mask mode the flux blocks use, the
concept rows' cross- and self-attention both on; calls in another mode
(the ablations) keep the default instance (`flash_saliency.default_instance`).

A candidate whose shape contract refuses the input (a ValueError raised
before any launch) is skipped; a CUDA error is never swallowed, because the
context is broken after it.

CLI:
    python -m conceptattention_torch.kernels.autotune --seq 4352 \\
        --batch 1 --heads 24 --head_dim 128
    python -m conceptattention_torch.kernels.autotune --seq 4355 \\
        --txt_len 256 --concepts 3
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_DEFAULT_CACHE = os.path.join(
    os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")),
    "conceptattention_torch",
    "tiles.json",
)


def default_cache_path() -> str:
    return _DEFAULT_CACHE


def _device_kind() -> str:
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return "cpu"


def _segments(seq_len: int, segments: Optional[Sequence[int]]) -> Tuple[int, int, int]:
    """(txt, img, concept) rows; None is JAX's probe, all txt."""
    return (int(seq_len), 0, 0) if segments is None else tuple(int(x) for x in segments)


def _key(key: Tuple[int, ...]) -> str:
    """The cache's key of an overlay key: its fields joined by ':'."""
    return ":".join(str(x) for x in key)


def candidate_tiles(s: int, head_dim: int = 128) -> List[int]:
    """The instance indices that take a call of sequence length `s` at this
    head dim: every compiled one (each masks its ragged edge, so all apply
    at any S)."""
    from conceptattention_torch.kernels.flash_saliency import hopper_instances

    return list(hopper_instances(head_dim))


def measure_tile(
    s: int,
    instance: int,
    batch: int = 1,
    heads: int = 24,
    head_dim: int = 128,
    iters: int = 4,
    with_rope: bool = True,
    segments: Optional[Sequence[int]] = None,
    device="cuda",
) -> float:
    """Measured TFLOP/s of one call of the Hopper kernel's `instance`, with
    RoPE so the production pre-pass runs; ops = 4 D H B times the (query,
    key) pairs the mask lets through. By default the JAX probe, pure
    self-attention (`txt_len=s`, ops = 4 S^2 D H B); `segments=(txt, img,
    concepts)` times the concept-attention call of that layout. The probe defaults to batch 1 and 24 heads, the
    flux blocks' shape, because the instance choice depends on how many
    blocks a call launches. On a CPU device it times the plain version
    (only so the sweep's plumbing can be tested)."""
    from conceptattention_torch.kernels.flash_saliency import (
        expand_rope_tables,
        fused_concept_flash_attention_hopper,
        segment_mask,
    )
    from conceptattention_torch.utils.profiling import loop_rate

    gen = torch.Generator(device).manual_seed(42)
    shape = (batch, heads, s, head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    rope_cos = rope_sin = None
    if with_rope:
        ang = torch.rand((batch, 1, s, head_dim // 2), generator=gen, device=device) * 6.28
        rope_cos, rope_sin = expand_rope_tables([(torch.cos(ang), torch.sin(ang))], s)

    t, p, c = _segments(s, segments)

    def attn(q, k, v):
        return fused_concept_flash_attention_hopper(
            q, k, v, t, p, c, rope_cos=rope_cos, rope_sin=rope_sin, instance=instance)

    dt = loop_rate(attn, q, k, v, iters=iters)
    pairs = int(segment_mask(s, t, p, c, True, True, device).sum())
    ops = 4 * pairs * head_dim * heads * batch  # qk + av, 2 ops per MAC
    return ops / dt / 1e12


def autotune_tiles(
    seq_len: int,
    batch: int = 1,
    heads: int = 24,
    head_dim: int = 128,
    candidates: Optional[Sequence[int]] = None,
    iters: int = 4,
    cache_path: Optional[str] = None,
    verbose: bool = False,
    segments: Optional[Sequence[int]] = None,
    device="cuda",
) -> int:
    """Sweep the candidate instances on the device, register and persist
    the winner, and return it; later calls of the probe's workload (head
    dim, seq_len, batch x heads, segments), a model forward's among them,
    take it. A candidate whose shape contract refuses the input
    (ValueError) is skipped; any other error raises."""
    cands = list(candidates) if candidates is not None else candidate_tiles(seq_len, head_dim)
    rates: Dict[int, float] = {}
    for inst in cands:
        try:
            rate = measure_tile(seq_len, inst, batch, heads, head_dim, iters=iters,
                                segments=segments, device=device)
        except ValueError as e:  # refused before any launch
            if verbose:
                print(f"  instance {inst}: refused ({e})")
            continue
        rates[inst] = rate
        if verbose:
            print(f"  instance {inst}: {rate:.1f} TFLOP/s")
    if not rates:
        raise RuntimeError(f"no feasible tile candidate for S={seq_len}")
    best = max(rates, key=rates.get)
    register_tuned_tiles(seq_len, best, head_dim, batch * heads, segments)
    _save_cache_entry(seq_len, best, rates[best], batch, heads, head_dim,
                      cache_path or _DEFAULT_CACHE, segments)
    return best


def _tile_key(seq_len, head_dim, batch_heads, segments):
    from conceptattention_torch.kernels.flash_saliency import tile_key

    return tile_key(head_dim, seq_len, batch_heads, *_segments(seq_len, segments))


def register_tuned_tiles(seq_len: int, instance: int, head_dim: int = 128,
                         batch_heads: int = 24, segments: Optional[Sequence[int]] = None) -> None:
    """Runtime overlay: takes precedence over the default instance for
    calls of this workload (segments None: pure self-attention) in the
    flux blocks' mask mode."""
    from conceptattention_torch.kernels import flash_saliency

    flash_saliency._TUNED_TILES[_tile_key(seq_len, head_dim, batch_heads, segments)] = int(
        instance)


def _save_cache_entry(seq_len, instance, rate, batch, heads, head_dim, path,
                      segments=None) -> None:
    data = {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        pass
    key = _tile_key(seq_len, head_dim, batch * heads, segments)
    data.setdefault(_device_kind(), {})[_key(key)] = {
        "instance": int(instance),
        "tflops": round(float(rate), 4),
        "probe": {"batch": batch, "heads": heads, "head_dim": head_dim},
    }
    parent = os.path.dirname(path)
    if parent:  # bare filenames have no directory to create
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, path)


def load_tile_cache(path: Optional[str] = None) -> Dict[Tuple[int, ...], int]:
    """Fill the runtime overlay from the persisted cache for THIS card kind:
    {flash_saliency.tile_key(...): instance}. Read lazily by the first card
    call of the Hopper kernel; a missing or corrupt file gives {}, and an
    entry whose key is not a whole workload is skipped."""
    from conceptattention_torch.kernels import flash_saliency

    path = path or _DEFAULT_CACHE
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    loaded = {}
    for key, ent in data.get(_device_kind(), {}).items():
        try:
            loaded[flash_saliency.tile_key(*(int(x) for x in key.split(":")))] = int(
                ent["instance"])
        except (KeyError, TypeError, ValueError):
            continue
    flash_saliency._TUNED_TILES.update(loaded)
    return loaded


def main(argv=None) -> None:
    from conceptattention_torch.kernels.flash_saliency import FLASH_D128_INSTANCES

    p = argparse.ArgumentParser(
        prog="conceptattention_torch.kernels.autotune",
        description="Sweep the flash kernel's compiled instances on the current card",
    )
    p.add_argument("--seq", type=int, nargs="+", required=True,
                   help="sequence lengths to tune (flux 1024^2 with 3 concepts: 4355 doubles, "
                        "4352 singles; 512^2 eval with 6 concepts: 1286)")
    p.add_argument("--txt_len", type=int, default=None,
                   help="txt rows of the probe; the rest are img and --concepts rows (default: "
                        "pure self-attention, every row txt, the single blocks' call)")
    p.add_argument("--concepts", type=int, default=0, help="concept rows (with --txt_len)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--heads", type=int, default=24)
    p.add_argument("--head_dim", type=int, default=128)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--cache_path", default=None)
    p.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    args = p.parse_args(argv)

    for s in args.seq:
        segments = None
        if args.txt_len is not None:
            segments = (args.txt_len, s - args.txt_len - args.concepts, args.concepts)
        print(f"S={s}: sweeping {len(candidate_tiles(s, args.head_dim))} instances")
        best = autotune_tiles(
            s, args.batch, args.heads, args.head_dim,
            iters=args.iters, cache_path=args.cache_path, verbose=True, segments=segments,
            device=args.device,
        )
        name = FLASH_D128_INSTANCES[best] if args.head_dim == 128 else "the only one"
        print(f"S={s}: best instance {best} {name} "
              f"(cached at {args.cache_path or _DEFAULT_CACHE})")


if __name__ == "__main__":
    main()
