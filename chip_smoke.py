#!/usr/bin/env python3
"""Drive the PyTorch port (`conceptattention_torch`) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. In order it
1. prints the torch and CUDA versions and the card's name and power limit;
2. builds every kernel from `conceptattention_torch/csrc` (one nvcc per
   source, started together);
3. holds each kernel against its plain PyTorch version in bf16 at the main
   paths' shapes (attention per row segment, each against its own scale;
   K1b, the int8-score attention, also against K1 and its pre-pass against
   the plain quantizer;
   at the CogVideoX shape the plain version runs on a subset of heads of
   the full-shape launch; K4, the ring kernel, on a virtual ring of 4 ranks
   on card 0, and on a ring of 2 across cards 0 and 1 where there are two),
   shows with planted controls (the plain version with one fault) that each
   limit sees such a fault, and times kernel, plain version and one library
   call that computes the same function (the port never calls it); where a
   redesigned Hopper instance took over a shape (K1 at head dims 64, 128 and
   512, K2 in bf16), the earlier kernel's time on the same input is read
   beside it;
4. checks the full-width models against their plain reference paths on a
   small input (DiT blocks: kernel vs SDPA backend, and the ring_rdma
   backend vs the fused one, with a control for each limit; VAE decodes:
   card vs CPU f32);
5. runs flux-schnell `generate_image` (1024x1024, 4 steps, 3 concepts,
   random weights from init_seed 0) twice and `encode_image` (1024x1024)
   twice; the int8 serving path on the same weights quantized to w8a8 with
   int8 scores (K1b): `generate_image` against the bf16 heatmaps,
   `generate_images` of two prompts cold and warm, `encode_image`; one
   `generate_image` each with random already-quantized w8 and w4 weights;
   `generate_image` and `encode_image` twice each with
   `attention_backend="ring_rdma"` over `make_mesh(seq=4)` on card 0; then
   CogVideoX-5b `generate_video` (13 latent frames of 60x90,
   STEPS_VIDEO steps, 3 concepts) cold and warm, once with the head-paired
   kernel, once with DPM-Solver++, decodes a short clip, and runs once with
   its blocks quantized to w8a8; every kernel's launch count (and the Hopper
   instances', which take K1 at head dims 64, 128 and 512) is set to 0 just
   before and read just after each run;
6. prints the Hopper instances' launches on the bf16 `generate_image` and
   `encode_image`, one `kernels` JSON line, then the result line.
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 rate
PROMPT = "a photo of a dragon on a rock under the sky"
CONCEPTS = ["dragon", "rock", "sky"]
SIZE = 1024
STEPS = 4
# CogVideoX-5b's production shape: 13 latent frames of 60x90 (a 49-frame
# 480x720 clip), 17550 video tokens; the pipeline's 50 steps are cut to
# STEPS_VIDEO to fit the time limit.
VIDEO_PROMPT = "a dragon flying over a rocky coast under the sky"
VIDEO_FRAMES, VIDEO_H, VIDEO_W = 13, 60, 90
STEPS_VIDEO = 2
DECODE_FRAMES = 2  # latent frames of the decoded clip, full spatial size


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7) -> float:
    """Median of `reps` warm runs, each between two CUDA events."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """The least time for bf16 `flops` plus `int8_ops` at the tensor cores'
    peaks, or for `nbytes` at the HBM rate, whichever is larger."""
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Limits of the DiT reference check, relative to the sdpa path's largest
# value. Each sits between the kernel path's reading and its control's (on an
# H100: pred 0.0034 against 0.033 with 64 txt keys dropped; saliency 0.0033
# against 0.0156 with the concept self-attention off).
DIT_PRED_LIMIT = 2.0**-7
DIT_SALIENCY_LIMIT = 2.0**-7
# The video DiT's pred is held by relative RMS, not max: its max |d| is one
# bf16 step at the largest value (0.0062 of it) for the kernel paths and for
# a 64-txt-key fault alike. On an H100: kernel paths 0.0028, 64 txt keys
# dropped 0.0054. Its saliency keeps the max-based limit (kernel paths
# 0.0055, concept self-attention off 0.085).
VIDEO_PRED_RMS_LIMIT = 2.0**-8
Q_SCALE = 3.0  # q at 3x unit scale: scores ~ N(0, 9), a peaked softmax, outputs O(|v|)


def limit_of(want: torch.Tensor) -> float:
    """2^-7 of the largest plain output, one to two bf16 steps there: the
    kernel and its plain version round P and the output to bf16 from sums
    taken in another order (and, for attention, against a running rather
    than a global max)."""
    return 2.0**-7 * want.float().abs().max().item()


def phase_result(name, kernel_fn, plain_fn, library_fn, flops, nbytes, launches,
                 segments=None, controls=(), select=None, plain_basis=None, int8_ops=0.0,
                 extra=None):
    """Kernel against plain version on each row segment (the sequence axis
    of attention), each against its own scale. Every control is the plain
    version with one planted fault; it must break the limit of the segment
    it faults, which shows the limit can see such a fault. `select` picks
    from the kernel's output what the plain version computes (a subset of
    heads), and `plain_basis` says so in the result. `extra(got)` returns
    readings of the kernel's output to add, with an "ok" of their own."""
    segments = segments or {"all": slice(None)}
    got = kernel_fn()
    torch.cuda.synchronize()
    if select is not None:
        got = select(got)
    want = plain_fn()
    checks, ok = {}, True
    for seg, rows in segments.items():
        w = want[:, :, rows]
        err, limit = (got[:, :, rows].float() - w.float()).abs().max().item(), limit_of(w)
        checks[seg] = {"max_abs_err": err, "limit": limit}
        ok = ok and err <= limit
    for label, seg, control_fn in controls:
        rows = segments[seg]
        err = (control_fn(want)[:, :, rows].float() - want[:, :, rows].float()).abs().max().item()
        checks[f"control: {label}"] = {"max_abs_err": err, "limit": checks[seg]["limit"]}
        ok = ok and err > checks[seg]["limit"]
    readings = extra(got) if extra else {}
    ok = ok and readings.pop("ok", True)
    sound = [c for k, c in checks.items() if not k.startswith("control")]
    bound_ms, bound_by = bound(flops, nbytes, int8_ops)
    res = {
        "phase": name, "ok": ok, "max_abs_err": max(c["max_abs_err"] for c in sound),
        "err_over_limit": max(c["max_abs_err"] / max(c["limit"], 1e-30) for c in sound),
        "checks": checks,
        "kernel_ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
        "library_ms": time_ms(library_fn) if library_fn else None,
        "bound_ms": bound_ms, "bound_by": bound_by, "main_path_launches": launches,
        **readings,
    }
    if plain_basis:
        res["plain_basis"] = plain_basis
    print(json.dumps(res), flush=True)
    return res


def drop_key_tile(want, args, start, **kw):
    """The plain attention with the 64 keys [start, start + 64) taken out of
    the txt|img segment (what a kernel that skips one key tile computes), on
    every other row; the dropped rows keep the sound output. `kw` goes to
    the plain version (`int8_qk`)."""
    from conceptattention_torch.kernels.flash_saliency import fused_concept_flash_attention_plain

    q, k, v, t, p, c, *rest = args
    keep = torch.cat([torch.arange(start), torch.arange(start + 64, q.shape[2])]).to(q.device)
    t, p = (t - 64, p) if start < t else (t, p - 64)
    rest = [x[:, keep] if torch.is_tensor(x) else x for x in rest]  # [B, S, D] tables
    out = want.clone()
    out[:, :, keep] = fused_concept_flash_attention_plain(
        q[:, :, keep], k[:, :, keep], v[:, :, keep], t, p, c, *rest, **kw)
    return out


def mma_sync_reading(args):
    """Readings beside a K1 phase that the Hopper instance takes: the
    mma.sync kernel (`csrc/flash_saliency.cu`, which took head dims 64, 128
    and 512 before it) on the same input, launched directly, uncounted; and,
    with tables, the Hopper instance's RoPE pre-pass alone."""
    from conceptattention_torch.kernels import flash_saliency as fs

    q, k, *_, cos, sin = args

    def extra(got):
        out = {"mma_sync_ms": time_ms(lambda: fs._launch("ca_flash_saliency_bf16", *args))}
        if cos is not None:
            out["rope_prepass_ms"] = time_ms(lambda: fs.rope_qk_rows_cuda(q, k, cos, sin))
        return out
    return extra


def flash_phases(cfg, main_double, main_single, main_vae):
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import apply_rope, embed_nd

    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(1)
    h, d = cfg.num_heads, cfg.head_dim
    t, grid = 256, SIZE // 16
    p, c = grid * grid, len(CONCEPTS)
    img_ids = make_img_ids(grid, grid, 1, device=dev)
    pe = embed_nd(torch.cat([torch.zeros(1, t, 3, device=dev), img_ids], 1), cfg.axes_dim, cfg.theta)
    cpe = embed_nd(torch.cat([torch.zeros(1, c, 3, device=dev), img_ids], 1), cfg.axes_dim, cfg.theta)

    def qkv(b, heads, s, dim):
        q, k, v = (torch.randn(b, heads, s, dim, generator=gen, device=dev) for _ in range(3))
        return (Q_SCALE * q).bfloat16(), k.bfloat16(), v.bfloat16()

    def pairs(s, *seg, cross=True, self_attention=True):
        return fs.segment_mask(s, *seg, cross, self_attention, dev).sum().item()

    results = []
    s = t + p + c
    q, k, v = qkv(1, h, s, d)
    # Each concept key points along its own query, 4 units long. Its score
    # (about 4 sigma, concept positions rotate by the identity) competes with
    # the strongest img key's, so the concept rows' cross and self terms both
    # carry weight.
    qc = q[:, :, t + p:].float()
    k[:, :, t + p:] = (4.0 * qc / qc.norm(dim=-1, keepdim=True)).bfloat16()
    cos, sin = fs.expand_rope_tables([pe, (cpe[0][:, :, :c], cpe[1][:, :, :c])], s)
    qj, kj = apply_rope(q[:, :, :t + p], k[:, :, :t + p], pe)
    qc, kc = apply_rope(q[:, :, t + p:], k[:, :, t + p:], (cpe[0][:, :, :c], cpe[1][:, :, :c]))
    qr, kr = torch.cat([qj, qc], 2), torch.cat([kj, kc], 2)
    segments = {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)}
    for cross, self_attention in [(True, True), (True, False), (False, True), (False, False)]:
        mask = fs.segment_mask(s, t, p, c, cross, self_attention, dev)
        args = (q, k, v, t, p, c, cross, self_attention, cos, sin)
        flipped = {
            "self_attention flipped": (q, k, v, t, p, c, cross, not self_attention, cos, sin),
            "cross flipped": (q, k, v, t, p, c, not cross, self_attention, cos, sin),
        }
        controls = [(label, "concept rows", lambda _, a=a: fs.fused_concept_flash_attention_plain(*a))
                    for label, a in flipped.items()]
        if cross and self_attention:
            controls.append(("one img key tile dropped", "joint rows",
                             lambda want, a=args: drop_key_tile(want, a, t + 64 * 32)))
        n_pairs = pairs(s, t, p, c, cross=cross, self_attention=self_attention)
        results.append(phase_result(
            f"flash_saliency double_block S={s} cross={cross} self={self_attention}",
            lambda a=args: fs.fused_concept_flash_attention(*a),
            lambda a=args: fs.fused_concept_flash_attention_plain(*a),
            lambda m=mask: F.scaled_dot_product_attention(qr, kr, v, attn_mask=m),
            4 * d * n_pairs * h, 4 * h * s * d * 2 + 2 * s * d * 4,
            main_double if (cross and self_attention) else 0, segments, controls,
            extra=mma_sync_reading(args),
        ))

    s = t + p
    q, k, v = qkv(1, h, s, d)
    cos, sin = fs.expand_rope_tables([pe], s)
    qs, ks = apply_rope(q, k, pe)
    args = (q, k, v, s, 0, 0, True, True, cos, sin)
    results.append(phase_result(
        f"flash_saliency single_block S={s}",
        lambda: fs.fused_concept_flash_attention(*args),
        lambda: fs.fused_concept_flash_attention_plain(*args),
        lambda: F.scaled_dot_product_attention(qs, ks, v),
        4 * d * s * s * h, 4 * h * s * d * 2 + 2 * s * d * 4, main_single,
        controls=[("one key tile dropped", "all", lambda want: drop_key_tile(want, args, t + 64 * 32))],
        extra=mma_sync_reading(args),
    ))

    s, d = (SIZE // 8) ** 2, 512
    q, k, v = qkv(1, 1, s, d)
    vae_args = (q, k, v, s, 0, 0)
    results.append(phase_result(
        f"flash_saliency vae_mid_attention S={s} D={d}",
        lambda: fs.fused_concept_flash_attention(*vae_args),
        lambda: fs.fused_concept_flash_attention_plain(*vae_args),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * d * s * s, 4 * s * d * 2, main_vae,
        controls=[("one key tile dropped", "all", lambda want: drop_key_tile(want, vae_args, 64 * 128))],
        extra=mma_sync_reading((*vae_args, True, True, None, None)),
    ))
    return results


def swapped_key_halves(args):
    """The plain int8 attention with each 32-channel step of the int8 key
    rows read with its two 16-byte halves swapped: what a kernel that loads
    the s8 B fragment from the wrong `ldmatrix` rows computes (scores from
    mismatched channels, not noise)."""
    from conceptattention_torch.kernels import flash_saliency as fs

    quantize = fs.quantize_qk_rows_plain

    def swapped(*a):
        q8, qs, k8, ks = quantize(*a)
        perm = torch.arange(k8.shape[-1], device=k8.device).view(-1, 2, 16).flip(1).reshape(-1)
        return q8, qs, k8[..., perm], ks

    fs.quantize_qk_rows_plain = swapped
    try:
        return fs.fused_concept_flash_attention_plain(*args, int8_qk=True)
    finally:
        fs.quantize_qk_rows_plain = quantize


def int8_flash_phases(cfg, launches):
    """K1b (`int8_qk=True`) at the flux shapes, against its plain version:
    the double block (S = 256 txt + 4096 img + 3 concepts, RoPE) in all four
    ablations at batch 1 and on the path's (T,T) at batch 2, the single block
    (S = 4352) at batch 1 and 2. `launches` maps "double", "double b2",
    "single" and "single b2" to the main paths' launches. Each phase also
    reads K1 (exact scores) at the same shape: its time, K1b's max |d|
    against its output (a reading with no limit), and the count of int8
    values where the pre-pass and the plain quantizer differ (must be 0).
    No PyTorch call computes int8 scores, so there is no library time."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import embed_nd

    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(7)
    h, d = cfg.num_heads, cfg.head_dim
    t, grid = 256, SIZE // 16
    p, c = grid * grid, len(CONCEPTS)

    def inputs(b, s, concepts):
        img_ids = make_img_ids(grid, grid, b, device=dev)
        pe = embed_nd(torch.cat([torch.zeros(b, t, 3, device=dev), img_ids], 1), cfg.axes_dim,
                      cfg.theta)
        segments = [pe]
        if concepts:
            cpe = embed_nd(torch.cat([torch.zeros(b, c, 3, device=dev), img_ids], 1),
                           cfg.axes_dim, cfg.theta)
            segments.append((cpe[0][:, :, :c], cpe[1][:, :, :c]))
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
        q, k, v = (Q_SCALE * q).bfloat16(), k.bfloat16(), v.bfloat16()
        if concepts:  # concept keys along their own queries, as in `flash_phases`
            qc = q[:, :, t + p:].float()
            k[:, :, t + p:] = (4.0 * qc / qc.norm(dim=-1, keepdim=True)).bfloat16()
        return (q, k, v, *fs.expand_rope_tables(segments, s))

    def readings(args):
        def extra(got):
            exact = fs.fused_concept_flash_attention(*args)
            ours = fs.quantize_qk_rows_cuda(args[0], args[1], *args[-2:])
            plain = fs.quantize_qk_rows_plain(args[0], args[1], *args[-2:])
            diffs = sum(int((a != b).sum()) for a, b in ((ours[0], plain[0]), (ours[2], plain[2])))
            return {"k1_ms": time_ms(lambda: fs.fused_concept_flash_attention(*args)),
                    "k1b_vs_k1_max_abs": (got.float() - exact.float()).abs().max().item(),
                    "prepass_int8_diffs": diffs, "ok": diffs == 0}
        return extra

    def cost(b, s, n_pairs):
        # int8 Q.K^T and bf16 P.V over the unmasked pairs; q, k, v and the
        # output in bf16, the tables in f32
        return dict(flops=2 * d * n_pairs * h * b, int8_ops=2 * d * n_pairs * h * b,
                    nbytes=4 * b * h * s * d * 2 + 2 * b * s * d * 4)

    results = []
    s = t + p + c
    segments = {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)}
    for b in (1, 2):
        q, k, v, cos, sin = inputs(b, s, True)
        ablations = [(True, True), (True, False), (False, True), (False, False)] if b == 1 else [
            (True, True)]
        for cross, self_attention in ablations:
            args = (q, k, v, t, p, c, cross, self_attention, cos, sin)
            n_pairs = fs.segment_mask(s, t, p, c, cross, self_attention, dev).sum().item()
            controls = [("self_attention flipped", "concept rows",
                         lambda _, a=(q, k, v, t, p, c, cross, not self_attention, cos, sin):
                         fs.fused_concept_flash_attention_plain(*a, int8_qk=True))]
            if cross and self_attention:
                controls.append(("one img key tile dropped", "joint rows",
                                 lambda want, a=args: drop_key_tile(want, a, t + 64 * 32,
                                                                    int8_qk=True)))
            if cross and self_attention and b == 1:
                controls.append(("key halves swapped in each 32-channel step", "joint rows",
                                 lambda _, a=args: swapped_key_halves(a)))
            on_path = cross and self_attention
            results.append(phase_result(
                f"flash_saliency_int8 double_block B={b} S={s} cross={cross} self={self_attention}",
                lambda a=args: fs.fused_concept_flash_attention(*a, int8_qk=True),
                lambda a=args: fs.fused_concept_flash_attention_plain(*a, int8_qk=True),
                None, launches=launches["double" if b == 1 else "double b2"] if on_path else 0,
                segments=segments, controls=controls, extra=readings(args),
                **cost(b, s, n_pairs),
            ))
        del q, k, v, cos, sin
    s = t + p
    for b in (1, 2):
        q, k, v, cos, sin = inputs(b, s, False)
        args = (q, k, v, s, 0, 0, True, True, cos, sin)
        results.append(phase_result(
            f"flash_saliency_int8 single_block B={b} S={s}",
            lambda a=args: fs.fused_concept_flash_attention(*a, int8_qk=True),
            lambda a=args: fs.fused_concept_flash_attention_plain(*a, int8_qk=True),
            None, launches=launches["single" if b == 1 else "single b2"],
            controls=[("one key tile dropped", "all",
                       lambda want, a=args: drop_key_tile(want, a, t + 64 * 32, int8_qk=True))],
            extra=readings(args), **cost(b, s, s * s),
        ))
    torch.cuda.empty_cache()
    return results


def masked_sdpa(q, k, v, mask):
    """The library yardstick at the video shape: PyTorch's memory-efficient
    SDPA with the boolean segment mask (forced, so it never materializes the
    [B, H, S, S] scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def video_flash_phases(vcfg, launches_k1, launches_k3, dev="cuda"):
    """K1 at head dim 64 and K3 at the CogVideoX-5b shape: B = 2 (CFG),
    48 heads, S = 226 txt + 17550 video + 226 concept slots, RoPE. Each
    kernel runs on the full shape; the plain version (whose [B, H, S, S]
    scores would not fit) runs on batch row 1, heads (0, 1) and (46, 47),
    whole pairs, and is held against the same slice of the kernel's output."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.models.video.dit import make_video_ids
    from conceptattention_torch.ops.rope import embed_nd

    gen = torch.Generator(dev).manual_seed(4)
    b, h, d = 2, vcfg.num_attention_heads, vcfg.attention_head_dim
    gh, gw = VIDEO_H // vcfg.patch_size, VIDEO_W // vcfg.patch_size
    t = c = vcfg.max_text_seq_length
    p = VIDEO_FRAMES * gh * gw
    s = t + p + c
    ids = make_video_ids(VIDEO_FRAMES, gh, gw, b, device=dev)
    pe, cpe = (embed_nd(torch.cat([torch.zeros(b, n, 3, device=dev), ids], 1),
                        vcfg.rope_axes_dim, 10_000) for n in (t, c))
    cos, sin = fs.expand_rope_tables([pe, (cpe[0][:, :, :c], cpe[1][:, :, :c])], s)
    q = (Q_SCALE * torch.randn(b, h, s, d, generator=gen, device=dev)).bfloat16()
    k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    # Each concept key points along its own query, 4 units long, so the
    # concept rows' self term competes with the strongest video key.
    qc = q[:, :, t + p:].float()
    k[:, :, t + p:] = (4.0 * qc / qc.norm(dim=-1, keepdim=True)).bfloat16()
    qr, kr = (((x.float() * cos[:, None] + fs._pair_swap(x.float()) * sin[:, None])
               ).bfloat16() for x in (q, k))  # roped, for the library call

    heads = torch.tensor([0, 1, h - 2, h - 1], device=dev)
    basis = f"head subset: batch row 1, heads 0, 1, {h - 2}, {h - 1} of {b} x {h}"

    def sub(x):
        return x[1:2].index_select(1, heads).contiguous()

    def select(out):
        return out[1:2].index_select(1, heads)

    qs, ks, vs, cs, ss = sub(q), sub(k), sub(v), cos[1:2], sin[1:2]
    segments = {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)}
    results = {"k1": [], "k3": []}
    for cross, self_attention in [(True, True), (True, False), (False, True), (False, False)]:
        mask = fs.segment_mask(s, t, p, c, cross, self_attention, dev)
        n_pairs = mask.sum().item()
        sub_args = (qs, ks, vs, t, p, c, cross, self_attention, cs, ss)
        flipped = {
            "self_attention flipped": (qs, ks, vs, t, p, c, cross, not self_attention, cs, ss),
            "cross flipped": (qs, ks, vs, t, p, c, not cross, self_attention, cs, ss),
        }
        controls = [(label, "concept rows", lambda _, a=a: fs.fused_concept_flash_attention_plain(*a))
                    for label, a in flipped.items()]
        if cross and self_attention:
            controls.append(("one video key tile dropped", "joint rows",
                             lambda want, a=sub_args: drop_key_tile(want, a, t + 64 * (p // 128))))
        tag = f"B={b} H={h} D={d} S={s} cross={cross} self={self_attention}"
        on_path = cross and self_attention
        common = dict(segments=segments, controls=controls, select=select, plain_basis=basis)
        cost = (4 * d * n_pairs * h * b, 4 * b * h * s * d * 2 + 2 * b * s * d * 4)
        library = lambda m=mask: masked_sdpa(qr, kr, v, m)
        full_args = (q, k, v, t, p, c, cross, self_attention, cos, sin)
        results["k1"].append(phase_result(
            f"flash_saliency video {tag}",
            lambda a=full_args: fs.fused_concept_flash_attention(*a),
            lambda a=sub_args: fs.fused_concept_flash_attention_plain(*a),
            library, *cost, launches_k1 if on_path else 0, **common,
            extra=mma_sync_reading(full_args),
        ))
        results["k3"].append(phase_result(
            f"flash_saliency_paired video {tag}",
            lambda a=(q, k, v, cos, sin, t, p, c, cross, self_attention):
                fs.fused_concept_flash_attention_paired(*a),
            lambda a=(qs, ks, vs, cs, ss, t, p, c, cross, self_attention):
                fs.fused_concept_flash_attention_paired_plain(*a),
            library, *cost, launches_k3 if on_path else 0, **common,
        ))
        del mask
        torch.cuda.empty_cache()
    return results["k1"], results["k3"]


def faulty_ring(qs, ks, vs, t, p, c, origin_shift=0, skip_hop=None):
    """The plain ring (`parallel.ring_attention`, both concept passes on)
    with one planted fault: `origin_shift` places each held chunk's keys that
    many ring steps off their true positions (a kernel that computes the
    chunk's origin off by one); `skip_hop` leaves out the hop after that
    step, so the next step reads its double buffer's stale slot (a hop that
    never ran, or a step that read before the copy landed)."""
    from conceptattention_torch.parallel import ring_attention as ra

    n = len(qs)
    b, h, lc, d = qs[0].shape
    scale = ra.LOG2E / math.sqrt(d)
    iota = torch.arange(lc, device=qs[0].device)
    state = [(torch.full((b, h, lc, 1), ra.NEG_INF, device=q.device),
              torch.zeros((b, h, lc, 1), device=q.device),
              torch.zeros((b, h, lc, d), device=q.device)) for q in qs]
    slots = [[(ks[r], vs[r]), None] for r in range(n)]
    for step in range(n):
        cur = step % 2
        if step + 1 < n and step != skip_hop:
            moved = [slots[r - 1][cur] for r in range(n)]
            for r in range(n):
                slots[r][1 - cur] = moved[r]
        for my in range(n):
            src = (my - step - origin_shift) % n
            allowed = ra._segment_mask(my * lc + iota, src * lc + iota, t, p, c, True, True)
            state[my] = ra._partial_update(qs[my], *slots[my][cur], *state[my], scale, allowed)
    return torch.cat([(acc / torch.where(l == 0, torch.ones_like(l), l)).to(vs[0].dtype)
                      for _, l, acc in state], dim=2)


def fused_ring_inputs(gen, b, h, d, t, p, c, pe, cpe, n):
    """The fused [txt | img | concept] q, k, v of one block, roped per
    segment (K4 takes them roped), q at 3x scale and each concept key along
    its own query, 4 units long (as `flash_phases`), and the same padded with
    zero rows to a multiple of the ring size `n`."""
    from conceptattention_torch.ops.rope import apply_rope

    s, j = t + p + c, t + p
    q = (Q_SCALE * torch.randn(b, h, s, d, generator=gen, device="cuda")).bfloat16()
    k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    qc = q[:, :, j:].float()
    k[:, :, j:] = (4.0 * qc / qc.norm(dim=-1, keepdim=True)).bfloat16()
    qj, kj = apply_rope(q[:, :, :j], k[:, :, :j], pe)
    qc, kc = apply_rope(q[:, :, j:], k[:, :, j:], (cpe[0][:, :, :c], cpe[1][:, :, :c]))
    fused = (torch.cat([qj, qc], 2), torch.cat([kj, kc], 2), v)
    pad = -(-s // n) * n - s
    return fused, tuple(F.pad(x, (0, 0, 0, pad)).contiguous() for x in fused)


def ring_phases(cfg, vcfg, launches, n=4):
    """K4 on a virtual ring of `n` ranks on card 0, against its plain
    version (the "ring" backend's ring on the same mesh): the flux double
    block (B1 H24 D128, S = 256 + 4096 + 3 padded to a multiple of n) in all
    four ablations, and the CogVideoX-5b block (B2 H48 D64, S = 226 + 17550
    + 226 padded), whose plain version runs on 4 of the 96 (batch, head)
    rows as K1's video phase does. Rows are held per segment; the pad rows'
    limit is 0 (they must be exact zeros). Controls: the plain ring with the
    chunk origin one step off, with one hop skipped, and with the
    self_attention flag flipped. Readings beside the times: K1 on the same
    fused input (unsharded), the bytes the hops move, the step launches.
    The library call is masked SDPA over the unsharded sequence."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels import ring_rdma as rr
    from conceptattention_torch.models.video.dit import make_video_ids
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import embed_nd
    from conceptattention_torch.parallel import make_mesh
    from conceptattention_torch.parallel.ring_attention import make_ring_concept_attention

    dev = "cuda"
    mesh = make_mesh(seq=n, devices=[torch.device(dev, 0)] * n)
    gen = torch.Generator(dev).manual_seed(8)

    def shards(x):
        lc = x.shape[2] // n
        return [x[:, :, r * lc:(r + 1) * lc].contiguous() for r in range(n)]

    def readings(fused, padded, t, p, c, cross, self_attention):
        def extra(got):
            before = rr.ring_attention_rdma.step_launches
            rr.make_ring_concept_attention_rdma(mesh, "seq", t, p, c, cross, self_attention)(*padded)
            b, h, s_pad, d = padded[0].shape
            return {"k1_ms": time_ms(lambda: fs.fused_concept_flash_attention(
                        *fused, t, p, c, cross, self_attention)),
                    # N - 1 hops of every rank's bf16 K and V chunk
                    "hop_bytes_per_call": (n - 1) * 2 * b * h * s_pad * d * 2,
                    "step_launches_per_call": rr.ring_attention_rdma.step_launches - before}
        return extra

    def segments(t, p, c, s_pad):
        return {"joint rows": slice(0, t + p), "concept rows": slice(t + p, t + p + c),
                "pad rows": slice(t + p + c, s_pad)}

    results = []
    h, d = cfg.num_heads, cfg.head_dim
    t, grid = 256, SIZE // 16
    p, c = grid * grid, len(CONCEPTS)
    img_ids = make_img_ids(grid, grid, 1, device=dev)
    pe, cpe = (embed_nd(torch.cat([torch.zeros(1, m, 3, device=dev), img_ids], 1), cfg.axes_dim,
                        cfg.theta) for m in (t, c))
    fused, padded = fused_ring_inputs(gen, 1, h, d, t, p, c, pe, cpe, n)
    s, s_pad = t + p + c, padded[0].shape[2]
    split = [shards(x) for x in padded]
    for cross, self_attention in [(True, True), (True, False), (False, True), (False, False)]:
        mask = fs.segment_mask(s, t, p, c, cross, self_attention, dev)
        n_pairs = mask.sum().item()
        controls = [("self_attention flipped", "concept rows",
                     lambda _, a=(cross, not self_attention):
                     make_ring_concept_attention(mesh, "seq", t, p, c, *a)(*padded))]
        if cross and self_attention:
            controls += [("chunk origin off by one step", "joint rows",
                          lambda _: faulty_ring(*split, t, p, c, origin_shift=1)),
                         ("one hop skipped, stale slot reused", "joint rows",
                          lambda _: faulty_ring(*split, t, p, c, skip_hop=1))]
        results.append(phase_result(
            f"ring_attention double_block B=1 H={h} D={d} S={s}->{s_pad} N={n} "
            f"cross={cross} self={self_attention}",
            lambda a=(cross, self_attention): rr.make_ring_concept_attention_rdma(
                mesh, "seq", t, p, c, *a)(*padded),
            lambda a=(cross, self_attention): make_ring_concept_attention(
                mesh, "seq", t, p, c, *a)(*padded),
            lambda m=mask: F.scaled_dot_product_attention(fused[0], fused[1], fused[2], attn_mask=m),
            4 * d * n_pairs * h, 4 * h * s * d * 2,
            launches if (cross and self_attention) else 0, segments(t, p, c, s_pad), controls,
            extra=readings(fused, padded, t, p, c, cross, self_attention),
        ))
    del fused, padded, split

    b, h, d = 2, vcfg.num_attention_heads, vcfg.attention_head_dim
    gh, gw = VIDEO_H // vcfg.patch_size, VIDEO_W // vcfg.patch_size
    t = c = vcfg.max_text_seq_length
    p = VIDEO_FRAMES * gh * gw
    ids = make_video_ids(VIDEO_FRAMES, gh, gw, b, device=dev)
    pe, cpe = (embed_nd(torch.cat([torch.zeros(b, m, 3, device=dev), ids], 1),
                        vcfg.rope_axes_dim, 10_000) for m in (t, c))
    fused, padded = fused_ring_inputs(gen, b, h, d, t, p, c, pe, cpe, n)
    s, s_pad = t + p + c, padded[0].shape[2]
    heads = torch.tensor([0, 1, h - 2, h - 1], device=dev)
    sub = [x[1:2].index_select(1, heads).contiguous() for x in padded]
    split = [shards(x) for x in sub]
    mask = fs.segment_mask(s, t, p, c, True, True, dev)
    plain = make_ring_concept_attention(mesh, "seq", t, p, c)
    results.append(phase_result(
        f"ring_attention video B={b} H={h} D={d} S={s}->{s_pad} N={n} cross=True self=True",
        lambda: rr.make_ring_concept_attention_rdma(mesh, "seq", t, p, c)(*padded),
        lambda: plain(*sub),
        lambda: masked_sdpa(*fused, mask),
        4 * d * mask.sum().item() * h * b, 4 * b * h * s * d * 2, 0, segments(t, p, c, s_pad),
        [("self_attention flipped", "concept rows",
          lambda _: make_ring_concept_attention(mesh, "seq", t, p, c, True, False)(*sub)),
         ("chunk origin off by one step", "joint rows",
          lambda _: faulty_ring(*split, t, p, c, origin_shift=1)),
         ("one hop skipped, stale slot reused", "joint rows",
          lambda _: faulty_ring(*split, t, p, c, skip_hop=1))],
        select=lambda out: out[1:2].index_select(1, heads),
        plain_basis=f"head subset: batch row 1, heads 0, 1, {h - 2}, {h - 1} of {b} x {h}",
        extra=readings(fused, padded, t, p, c, True, True),
    ))
    del fused, padded, sub, split, mask
    torch.cuda.empty_cache()
    return results


def cross_card_ring_phase(cfg):
    """K4 on a ring of 2 across cards 0 and 1 (each rank's q, state and comm
    buffers on its own card, the hops peer copies) at the flux double block,
    against its plain version. Needs two cards; with one it prints why it
    did not run and returns None."""
    if torch.cuda.device_count() < 2:
        print("ring_attention across cards: not run: this machine has "
              f"{torch.cuda.device_count()} CUDA card; a ring of 2 across cards 0 and 1 needs two",
              flush=True)
        return None
    from conceptattention_torch.kernels import ring_rdma as rr
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import embed_nd
    from conceptattention_torch.parallel import make_mesh
    from conceptattention_torch.parallel.ring_attention import make_ring_concept_attention

    mesh = make_mesh(seq=2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    gen = torch.Generator("cuda").manual_seed(9)
    h, d, t, grid, c = cfg.num_heads, cfg.head_dim, 256, SIZE // 16, len(CONCEPTS)
    p = grid * grid
    img_ids = make_img_ids(grid, grid, 1, device="cuda")
    pe, cpe = (embed_nd(torch.cat([torch.zeros(1, m, 3, device="cuda"), img_ids], 1),
                        cfg.axes_dim, cfg.theta) for m in (t, c))
    _, padded = fused_ring_inputs(gen, 1, h, d, t, p, c, pe, cpe, 2)
    s_pad = padded[0].shape[2]
    return phase_result(
        f"ring_attention double_block across cards 0 and 1 S={t + p + c}->{s_pad} N=2",
        lambda: rr.make_ring_concept_attention_rdma(mesh, "seq", t, p, c)(*padded),
        lambda: make_ring_concept_attention(mesh, "seq", t, p, c)(*padded),
        None, 4 * d * h * ((t + p) ** 2 + c * (p + c)), 4 * h * (t + p + c) * d * 2, 0,
        {"joint rows": slice(0, t + p), "concept rows": slice(t + p, t + p + c),
         "pad rows": slice(t + p + c, s_pad)},
        [("self_attention flipped", "concept rows",
          lambda _: make_ring_concept_attention(mesh, "seq", t, p, c, True, False)(*padded))],
    )


def ring_reference_checks(pipe, mesh):
    """`flux_dit_outputs` with the double blocks on the ring (`ring_rdma`
    over `mesh`; the single blocks on the plain path) against the same
    blocks with the fused kernels, to the DiT limits, with two planted
    controls on the ring path: 64 txt keys dropped, and the concept
    self-attention off."""
    from conceptattention_torch.ops.attention import ConceptAttentionSpec

    ring = dict(backend="ring_rdma", mesh=mesh)
    outs = flux_dit_outputs(pipe, lambda txt, txt_ids: {
        "fused": (ConceptAttentionSpec(backend="fused"), txt, txt_ids),
        "ring_rdma": (ConceptAttentionSpec(**ring), txt, txt_ids),
        "control: ring_rdma, 64 txt keys dropped": (ConceptAttentionSpec(**ring), txt[:, :-64],
                                                    txt_ids[:, :-64]),
        "control: ring_rdma, concept self_attention off": (
            ConceptAttentionSpec(self_attention=False, **ring), txt, txt_ids),
    }, torch.Generator(pipe.device).manual_seed(3))
    readings = flux_dit_readings(outs, "fused", "reference DiT ring (2+2 full-width blocks, 256px)")
    pred_ok = (readings["ring_rdma"][0] <= DIT_PRED_LIMIT
               < readings["control: ring_rdma, 64 txt keys dropped"][0])
    sal_ok = (readings["ring_rdma"][1] <= DIT_SALIENCY_LIMIT
              < readings["control: ring_rdma, concept self_attention off"][1])
    print(f"reference DiT ring limits: pred {DIT_PRED_LIMIT} ok={pred_ok}, "
          f"saliency {DIT_SALIENCY_LIMIT} ok={sal_ok}", flush=True)
    if not (pred_ok and sal_ok):
        raise AssertionError("DiT ring path against the fused kernel path: a reading or a "
                             "control is on the wrong side of its limit")


def video_ring_reference_checks(pipe, mesh):
    """`video_dit_outputs` with `ring_rdma` over `mesh` against the fused
    kernel path, to the video DiT limits, with the same two controls on the
    ring path."""
    from conceptattention_torch.ops.attention import ConceptAttentionSpec

    ring = dict(taps=("output", "cross_attention"), backend="ring_rdma", mesh=mesh)
    outs = video_dit_outputs(pipe, lambda text: {
        "fused": (ConceptAttentionSpec(taps=ring["taps"]), text, False),
        "ring_rdma": (ConceptAttentionSpec(**ring), text, False),
        "control: ring_rdma, 64 txt keys dropped": (ConceptAttentionSpec(**ring), text[:, :-64],
                                                    False),
        "control: ring_rdma, concept self_attention off": (
            ConceptAttentionSpec(self_attention=False, **ring), text, False),
    })
    readings = video_dit_readings(
        outs, "fused", "reference video DiT ring (2 full-width CogVideoX-5b blocks, 2x60x90 latents)")
    pred_ok = (readings["ring_rdma"][0] <= VIDEO_PRED_RMS_LIMIT
               < readings["control: ring_rdma, 64 txt keys dropped"][0])
    sal_ok = (readings["ring_rdma"][1] <= DIT_SALIENCY_LIMIT
              < readings["control: ring_rdma, concept self_attention off"][1])
    print(f"reference video DiT ring limits: pred rms {VIDEO_PRED_RMS_LIMIT} ok={pred_ok}, "
          f"saliency {DIT_SALIENCY_LIMIT} ok={sal_ok}", flush=True)
    if not (pred_ok and sal_ok):
        raise AssertionError("video DiT ring path against the fused kernel path: a reading or a "
                             "control is on the wrong side of its limit")


def decoder_conv_shapes(ae_cfg, latent: int) -> Counter:
    """(H, Cin, Cout) of every 3x3 conv of the decoder that the conv3x3 gate
    routes to the kernel, with its count per decode."""
    shapes = []
    res, ch = latent, ae_cfg.ch * ae_cfg.ch_mult[-1]
    shapes += [(res, ch, ch)] * 4  # mid_block_1, mid_block_2
    block_in = ch
    for i_level in reversed(range(len(ae_cfg.ch_mult))):
        block_out = ae_cfg.ch * ae_cfg.ch_mult[i_level]
        for _ in range(ae_cfg.num_res_blocks + 1):
            shapes += [(res, block_in, block_out), (res, block_out, block_out)]
            block_in = block_out
        if i_level != 0:
            res *= 2
            shapes.append((res, block_in, block_in))
    return Counter(s for s in shapes if s[1] % 128 == 0 and s[2] % 128 == 0 and s[0] % 8 == 0)


def conv_phases(conv_counts: Counter, decodes: int):
    """K2 at every decoder shape the gate admits (and one with swish): the
    Hopper instance against the plain version, with the generic kernel
    (`csrc/conv3x3.cu`, which took these shapes before it) timed beside it."""
    from conceptattention_torch.kernels.conv3x3 import (
        conv3x3_instance,
        conv3x3_same,
        conv3x3_same_generic,
        conv3x3_same_plain,
    )

    gen = torch.Generator("cuda").manual_seed(2)
    results = []
    cases = [(shape, False) for shape in sorted(conv_counts)] + [(min(conv_counts), True)]
    for (res, cin, cout), swish in cases:
        x = torch.randn(1, res, res, cin, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).bfloat16()
        b = (0.1 * torch.randn(cout, generator=gen, device="cuda")).bfloat16()
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        w_drop = w.clone()
        w_drop[0, 0, :32] = 0  # a kernel that skips one 32-deep K tile
        library = None if swish else (lambda: F.conv2d(x_nchw, w_oihw, b, padding=1))
        if conv3x3_instance(x.dtype, cin, cout) != "hopper":
            raise AssertionError(f"decoder conv {res}x{res} {cin}->{cout} would not take the Hopper K2")
        results.append(phase_result(
            f"conv3x3 H=W={res} Cin={cin} Cout={cout} swish={swish}",
            lambda: conv3x3_same(x, w, b, swish), lambda: conv3x3_same_plain(x, w, b, swish),
            library, 2 * res * res * cout * 9 * cin,
            2 * (res * res * (cin + cout) + 9 * cin * cout + cout),
            0 if swish else decodes * conv_counts[(res, cin, cout)],
            controls=[("one K tile dropped", "all",
                       lambda _, wd=w_drop: conv3x3_same_plain(x, wd, b, swish))],
            extra=lambda _: {"generic_ms": time_ms(lambda: conv3x3_same_generic(x, w, b, swish))},
        ))
    return results


def flux_dit_outputs(pipe, make_runs, gen):
    """Two full-width flux double and two single blocks on a 256px input
    drawn from `gen`, once per run of `make_runs(txt, txt_ids)` ({name:
    (spec, txt, txt_ids)}). Returns {name: (pred, saliency)}."""
    from conceptattention_torch.models.flux.dit import flux_forward
    from conceptattention_torch.ops.packing import make_img_ids

    cfg, dev, size = pipe.cfg, pipe.device, 256
    grid = size // 16
    txt, txt_ids, vec = pipe._prepare_text(PROMPT)
    c_emb, c_ids, c_vec = pipe._prepare_concepts(CONCEPTS)
    img = torch.randn(1, grid * grid, cfg.in_channels, generator=gen, device=dev).bfloat16()
    small = dataclasses.replace(cfg, depth=2, depth_single_blocks=2)
    return {
        name: flux_forward(
            pipe.params, small, img, make_img_ids(grid, grid, 1, device=dev), run_txt, run_ids,
            torch.full((1,), 0.5, device=dev), vec, concepts=c_emb, concept_ids=c_ids,
            concept_vec=c_vec, spec=spec,
        )
        for name, (spec, run_txt, run_ids) in make_runs(txt, txt_ids).items()
    }


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def flux_dit_readings(outs, reference, title):
    """{name: (pred, saliency)} against outs[reference]: max |d| over the
    reference's max, for pred and for the worst saliency tap; printed."""
    want_pred, want_sal = outs[reference]
    readings = {
        name: (rel_err(pred, want_pred), max(rel_err(sal[k], want_sal[k]) for k in want_sal))
        for name, (pred, sal) in outs.items() if name != reference
    }
    for name, (pred_rel, sal_rel) in readings.items():
        print(f"{title} {name} vs {reference}: "
              f"max|d pred|/max|pred| {pred_rel}, saliency max|d|/max {sal_rel}", flush=True)
    return readings


def reference_checks(pipe):
    """The full-width model on a small input against its plain reference path."""
    from conceptattention_torch.models.flux.params import tree_map
    from conceptattention_torch.ops.attention import ConceptAttentionSpec
    from conceptattention_torch.pipeline.concept_pipeline import _vae_decode

    cfg, dev = pipe.cfg, pipe.device
    gen = torch.Generator(dev).manual_seed(3)
    outs = flux_dit_outputs(pipe, lambda txt, txt_ids: {
        "fused": (ConceptAttentionSpec(backend="fused"), txt, txt_ids),
        "sdpa": (ConceptAttentionSpec(backend="sdpa"), txt, txt_ids),
        # Controls, one planted fault away from the sdpa path: the last 64
        # txt keys dropped (what a kernel that skips one key tile computes),
        # and the concept pass without its self-attention.
        "control: 64 txt keys dropped": (ConceptAttentionSpec(backend="sdpa"), txt[:, :-64],
                                         txt_ids[:, :-64]),
        "control: concept self_attention off": (
            ConceptAttentionSpec(backend="sdpa", self_attention=False), txt, txt_ids),
    }, gen)
    readings = flux_dit_readings(outs, "sdpa", "reference DiT (2+2 full-width blocks, 256px)")
    # bf16 activations through four blocks put the kernel a few tenths of a
    # percent off the sdpa path; each control must land above its limit.
    pred_ok = readings["fused"][0] <= DIT_PRED_LIMIT < readings["control: 64 txt keys dropped"][0]
    sal_ok = (readings["fused"][1] <= DIT_SALIENCY_LIMIT
              < readings["control: concept self_attention off"][1])
    print(f"reference DiT limits: pred {DIT_PRED_LIMIT} ok={pred_ok}, "
          f"saliency {DIT_SALIENCY_LIMIT} ok={sal_ok}", flush=True)
    if not (pred_ok and sal_ok):
        raise AssertionError("DiT kernel path against the SDPA reference path: a reading "
                             "or a control is on the wrong side of its limit")

    size = 512  # mid-attention over 4096 tokens, through the kernel
    grid = size // 16
    lat = torch.randn(1, grid * grid, cfg.in_channels, generator=gen, device=dev)
    got = _vae_decode(pipe.ae_params, pipe.spec.ae_params, lat, grid, grid, dtype=torch.bfloat16)
    cpu_ae = tree_map(lambda x: x.float().cpu(), {"decoder": pipe.ae_params["decoder"]})
    want = _vae_decode(cpu_ae, pipe.spec.ae_params, lat.cpu(), grid, grid, dtype=torch.float32)
    err = (got.float().cpu() - want).abs()
    rel = (err.pow(2).mean() / want.pow(2).mean()).sqrt().item()
    print(f"reference VAE decode ({size}px): card bf16 kernels vs CPU f32 plain: "
          f"relative RMS err {rel}, max abs err {err.max().item()}", flush=True)
    if not rel <= 5e-2:  # bf16 rounding through ~30 conv layers
        raise AssertionError("VAE decode on the card disagrees with the CPU f32 decode")


def video_dit_outputs(pipe, make_runs):
    """Two full-width CogVideoX-5b blocks on a 2-frame clip (226 + 2700 +
    226 tokens, CFG batch 2), once per run of `make_runs(text)` ({name:
    (spec, text, heads paired)}). Returns {name: (pred, saliency)}."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.models.flux.params import tree_map
    from conceptattention_torch.models.video.dit import video_dit_forward

    cfg, dev = pipe.cfg, pipe.device
    small = dataclasses.replace(cfg, num_layers=2)
    params = dict(pipe.params, blocks=tree_map(lambda x: x[:2], pipe.params["blocks"]))
    gen = torch.Generator(dev).manual_seed(5)
    video = torch.randn(2, 2, cfg.in_channels, VIDEO_H, VIDEO_W, generator=gen,
                        device=dev).to(pipe.dtype)
    text = torch.cat([pipe._encode_text(""), pipe._encode_text(VIDEO_PROMPT)])
    concepts = pipe.encode_concepts(CONCEPTS).expand(2, -1, -1)
    ts = torch.full((2,), 500.0, device=dev)
    outs = {}
    for name, (spec, run_text, paired) in make_runs(text).items():
        fs.PAIR_HEADS = paired
        outs[name] = video_dit_forward(params, small, video, run_text, ts, concepts=concepts,
                                       spec=spec)
    fs.PAIR_HEADS = False
    return outs


def rel_rms(got, want):
    d = got.float() - want.float()
    return (d.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()).item()


def video_dit_readings(outs, reference, title):
    """{name: (pred relative RMS, worst saliency tap max |d| over max)}
    against outs[reference]; printed with the pred's max-based reading."""
    want_pred, want_sal = outs[reference]
    readings = {
        name: (rel_rms(pred, want_pred), max(rel_err(sal[k], want_sal[k]) for k in want_sal))
        for name, (pred, sal) in outs.items() if name != reference
    }
    for name, (pred_rms, sal_rel) in readings.items():
        print(f"{title} {name} vs {reference}: rms|d pred|/rms|pred| {pred_rms}, "
              f"max|d pred|/max|pred| {rel_err(outs[name][0], want_pred)}, "
              f"saliency max|d|/max {sal_rel}", flush=True)
    return readings


def video_reference_checks(pipe):
    """Two full-width CogVideoX-5b blocks on a 2-frame clip: the kernel paths
    (K1, and K3 with the heads paired) against the plain SDPA path, on pred
    and on both saliency taps, each limit with a planted control."""
    from conceptattention_torch.ops.attention import ConceptAttentionSpec

    taps = ("output", "cross_attention")
    outs = video_dit_outputs(pipe, lambda text: {
        "fused": (ConceptAttentionSpec(taps=taps), text, False),
        "fused, heads paired": (ConceptAttentionSpec(taps=taps), text, True),
        "sdpa": (ConceptAttentionSpec(taps=taps, backend="sdpa"), text, False),
        # Controls, one planted fault away from the sdpa path: the last 64
        # txt keys dropped, and the concept pass without its self-attention.
        "control: 64 txt keys dropped": (ConceptAttentionSpec(taps=taps, backend="sdpa"),
                                         text[:, :-64], False),
        "control: concept self_attention off": (
            ConceptAttentionSpec(taps=taps, backend="sdpa", self_attention=False), text, False),
    })
    readings = video_dit_readings(
        outs, "sdpa", "reference video DiT (2 full-width CogVideoX-5b blocks, 2x60x90 latents)")
    kernel_runs = ("fused", "fused, heads paired")
    pred_ok = (max(readings[n][0] for n in kernel_runs) <= VIDEO_PRED_RMS_LIMIT
               < readings["control: 64 txt keys dropped"][0])
    sal_ok = (max(readings[n][1] for n in kernel_runs) <= DIT_SALIENCY_LIMIT
              < readings["control: concept self_attention off"][1])
    print(f"reference video DiT limits: pred rms {VIDEO_PRED_RMS_LIMIT} ok={pred_ok}, "
          f"saliency {DIT_SALIENCY_LIMIT} ok={sal_ok}", flush=True)
    if not (pred_ok and sal_ok):
        raise AssertionError("video DiT kernel paths against the SDPA reference path: a reading "
                             "or a control is on the wrong side of its limit")


def video_decode_checks(pipe, latents):
    """decode_latents on DECODE_FRAMES latent frames at full spatial size and
    channel widths, and a small card-vs-CPU f32 decode check."""
    from conceptattention_torch.models.flux.params import tree_map
    from conceptattention_torch.models.video import vae as vvae
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = pipe.decode_latents(latents[:, :DECODE_FRAMES])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # An even latent frame count doubles every frame twice (no first-frame
    # special case): 2 latent frames give 8.
    want = (4 * DECODE_FRAMES, 8 * VIDEO_H, 8 * VIDEO_W, 3)
    if frames.shape != want or frames.dtype != np.uint8:
        raise AssertionError(f"bad decoded clip {frames.shape} {frames.dtype}, want {want}")
    print(f"decode_latents {DECODE_FRAMES} latent frames of {VIDEO_H}x{VIDEO_W}: "
          f"frames {list(frames.shape)}, seconds {seconds:.4f}", flush=True)

    vae_cfg, vae_params = pipe._vae()
    z = torch.randn(1, vae_cfg.latent_channels, 2, 8, 8,
                    generator=torch.Generator(pipe.device).manual_seed(6), device=pipe.device)
    with torch.inference_mode(), _full_f32():
        got = vvae.decode(vae_params, vae_cfg, z).cpu()
        cpu_params = tree_map(lambda x: x.cpu(), {"decoder": vae_params["decoder"]})
        want_px = vvae.decode(cpu_params, vae_cfg, z.cpu())
    err = (got - want_px).abs()
    rel = (err.pow(2).mean() / want_px.pow(2).mean()).sqrt().item()
    print(f"reference video VAE decode (2x8x8 latents, full channel widths): card f32 vs CPU f32: "
          f"relative RMS err {rel}, max abs err {err.max().item()}", flush=True)
    if not rel <= 1e-3:  # f32 on both sides: only the summation order differs
        raise AssertionError("video VAE decode on the card disagrees with the CPU decode")
    return seconds


def video_path(counters):
    """CogVideoX-5b `generate_video` at 13x60x90: cold and warm with K1,
    once with the heads paired (K3), once with DPM-Solver++, then the
    decode. Counters are [K1, K3, K1 hopper]. Returns a summary of each run."""
    from conceptattention_torch import VideoConceptAttentionPipeline
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.models.video.dit import cogvideox_5b_config
    from conceptattention_torch.parallel import make_mesh

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = VideoConceptAttentionPipeline(cogvideox_5b_config(), init_seed=0)
    torch.cuda.synchronize()
    print(f"video pipeline init seconds {time.perf_counter() - t0:.3f}", flush=True)
    video_reference_checks(pipe)
    video_ring_reference_checks(pipe, make_mesh(seq=4, devices=[torch.device("cuda", 0)] * 4))

    cfg = pipe.cfg
    per_run = cfg.num_layers * STEPS_VIDEO
    print(f"generate_video steps cut from the pipeline's 50 to {STEPS_VIDEO} "
          f"({per_run} DiT-block attention launches per run)", flush=True)
    grid = (len(CONCEPTS), VIDEO_FRAMES, VIDEO_H // cfg.patch_size, VIDEO_W // cfg.patch_size)
    runs = [("ddim cold", False, "ddim"), ("ddim warm", False, "ddim"),
            ("ddim heads paired", True, "ddim"), ("dpm", False, "dpm")]
    outs, summary = {}, {}
    for label, paired, scheduler in runs:
        fs.PAIR_HEADS = paired
        out, seconds, launches = counted(lambda: pipe.generate_video(
            VIDEO_PROMPT, CONCEPTS, num_frames=VIDEO_FRAMES, height=VIDEO_H, width=VIDEO_W,
            num_inference_steps=STEPS_VIDEO, guidance_scale=6.0, return_cross_attention=True,
            scheduler=scheduler,
        ), counters)
        fs.PAIR_HEADS = False
        want = [0, per_run, 0] if paired else [per_run, 0, per_run]
        if launches != want:
            raise AssertionError(
                f"generate_video {label}: launches [K1, K3, K1 hopper] {launches} != {want}")
        for maps in (out.concept_heatmaps, out.cross_attention_maps):
            if maps.shape != grid or not np.isfinite(maps).all():
                raise AssertionError(f"bad video heatmaps {maps.shape}, want {grid}")
        if not torch.isfinite(out.video_latents).all():
            raise AssertionError("non-finite video latents")
        outs[label] = out
        summary[label] = {"seconds": seconds, "launches [K1, K3, K1 hopper]": launches}
        print(f"generate_video {label}: {VIDEO_FRAMES}x{VIDEO_H}x{VIDEO_W} latents, "
              f"{STEPS_VIDEO} steps, launches [K1, K3, K1 hopper] {launches}, seconds {seconds:.4f}",
              flush=True)
    a, b = outs["ddim warm"], outs["ddim heads paired"]
    paired_vs_k1 = {
        "concept_heatmaps max abs diff": float(np.abs(a.concept_heatmaps - b.concept_heatmaps).max()),
        "cross_attention_maps max abs diff": float(
            np.abs(a.cross_attention_maps - b.cross_attention_maps).max()),
        "latents max abs diff": (a.video_latents.float() - b.video_latents.float()).abs().max().item(),
        "heatmap max": float(a.concept_heatmaps.max()),
    }
    print(f"generate_video heads paired vs K1: {json.dumps(paired_vs_k1)}", flush=True)
    summary["decode seconds"] = video_decode_checks(pipe, outs["ddim warm"].video_latents)
    summary["peak device memory GiB"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"video peak device memory GiB {summary['peak device memory GiB']:.3f}", flush=True)
    return summary


def check_image_output(out, label):
    grid = SIZE // 16
    for maps in (out.concept_heatmaps, out.cross_attention_maps):
        if maps.shape != (len(CONCEPTS), grid, grid) or not np.isfinite(maps).all():
            raise AssertionError(f"{label}: bad heatmaps {maps.shape}")
    if out.image is not None and (out.image.shape != (SIZE, SIZE, 3) or out.image.dtype != np.uint8):
        raise AssertionError(f"{label}: bad image {out.image.shape} {out.image.dtype}")


def heatmap_agreement(got, want):
    """Per concept: max |d| over the bf16 run's largest value, and the IoU
    of the two maps thresholded at their own means."""
    rel, iou = [], []
    for g, w in zip(got, want):
        rel.append(float(np.abs(g - w).max() / np.abs(w).max()))
        mg, mw = g > g.mean(), w > w.mean()
        iou.append(float((mg & mw).sum() / max((mg | mw).sum(), 1)))
    return {"relative max abs diff": rel, "IoU at the mean": iou}


def quantized_flux_path(pipe, bf16_out, counters, conv_per_decode):
    """w8a8 + int8_qk from the bf16 pipeline's own weights (the layer stacks
    quantized by `quantize_flux_params`, the VAE shared): `generate_image`
    against the bf16 run's heatmaps, `generate_images` of two prompts
    (seeds 0 and 1) cold and warm, and `encode_image`. Counters are
    [K1, K1b, K2, K1 hopper, K2 hopper]. Returns {path: (launches, seconds)}."""
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.ops.quant import quantize_flux_params

    cfg = pipe.cfg
    per_image = STEPS * (cfg.depth + cfg.depth_single_blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_flux_params(pipe.params, mode="w8a8")
    torch.cuda.synchronize()
    print(f"quantize_flux_params w8a8 seconds {time.perf_counter() - t0:.3f}", flush=True)
    qpipe = ConceptAttentionFluxPipeline("flux-schnell", params=qparams, ae_params=pipe.ae_params,
                                         int8_qk=True)
    gen_kw = dict(width=SIZE, height=SIZE, num_inference_steps=STEPS, return_pil_heatmaps=False,
                  return_image_array=True)
    paths = {}

    def run(label, fn, want):
        out, seconds, launches = counted(fn, counters)
        if launches != want:
            raise AssertionError(f"{label}: launches [K1, K1b, K2, K1 hopper, K2 hopper] {launches} != {want}")
        for o in out if isinstance(out, list) else [out]:
            check_image_output(o, label)
        print(f"{label}: launches [K1, K1b, K2, K1 hopper, K2 hopper] {launches}, seconds {seconds:.4f}", flush=True)
        paths[label] = (launches, seconds)
        return out

    one = run("generate_image (w8a8, int8_qk, same weights)",
              lambda: qpipe.generate_image(PROMPT, CONCEPTS, **gen_kw),
              [1, per_image, conv_per_decode, 1, conv_per_decode])
    agreement = {tap: heatmap_agreement(getattr(one, tap), getattr(bf16_out, tap))
                 for tap in ("concept_heatmaps", "cross_attention_maps")}  # a reading, no limit
    print(f"w8a8 + int8_qk against bf16, same weights, prompt and seed: {json.dumps(agreement)}",
          flush=True)
    for label in ("cold", "warm"):
        outs = run(f"generate_images (w8a8, int8_qk, batch 2) {label}",
                   lambda: qpipe.generate_images([PROMPT] * 2, CONCEPTS, seeds=[0, 1], **gen_kw),
                   [2, per_image, 2 * conv_per_decode, 2, 2 * conv_per_decode])
    seed0 = {"concept_heatmaps max abs diff": float(np.abs(
        outs[0].concept_heatmaps - one.concept_heatmaps).max())}
    print(f"generate_images seed 0 against generate_image seed 0: {json.dumps(seed0)}", flush=True)
    image = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    enc = run("encode_image (int8_qk)", lambda: qpipe.encode_image(
        image, CONCEPTS, width=SIZE, height=SIZE, return_pil_heatmaps=False), [0, cfg.depth, 0, 0, 0])
    del enc
    return paths


def random_quantized_paths(counters, conv_per_decode):
    """flux-schnell with random already-quantized weights (`quantize="w8"`
    and `"w4"`): init, then one `generate_image`. Counters are [K1, K1b, K2, K1 hopper, K2 hopper]."""
    from conceptattention_torch import ConceptAttentionFluxPipeline

    paths = {}
    for mode in ("w8", "w4"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = ConceptAttentionFluxPipeline("flux-schnell", quantize=mode, init_seed=0)
        torch.cuda.synchronize()
        init_seconds = time.perf_counter() - t0
        cfg = pipe.cfg
        per_image = STEPS * (cfg.depth + cfg.depth_single_blocks)
        want = [per_image + 1, 0, conv_per_decode, per_image + 1, conv_per_decode]
        out, seconds, launches = counted(lambda: pipe.generate_image(
            PROMPT, CONCEPTS, width=SIZE, height=SIZE, num_inference_steps=STEPS,
            return_pil_heatmaps=False, return_image_array=True), counters)
        if launches != want:
            raise AssertionError(f"generate_image ({mode}): launches {launches} != {want}")
        check_image_output(out, f"generate_image ({mode})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"generate_image ({mode}, random quantized init) {SIZE}x{SIZE} {STEPS} steps: "
              f"launches [K1, K1b, K2, K1 hopper, K2 hopper] {launches}, init seconds {init_seconds:.3f}, "
              f"seconds {seconds:.4f}, peak device memory GiB {peak:.3f}", flush=True)
        paths[f"generate_image ({mode})"] = (launches, seconds)
        del pipe, out
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def quantized_video_path(counters):
    """CogVideoX-5b with its blocks quantized to w8a8: one `generate_video`
    at 13x60x90, STEPS_VIDEO DDIM steps. Counters are [K1, K3, K1 hopper].
    Returns the run's K1 launches."""
    from conceptattention_torch import VideoConceptAttentionPipeline
    from conceptattention_torch.models.video.dit import cogvideox_5b_config

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = VideoConceptAttentionPipeline(cogvideox_5b_config(), init_seed=0, quantize="w8a8")
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    cfg = pipe.cfg
    per_run = cfg.num_layers * STEPS_VIDEO
    out, seconds, launches = counted(lambda: pipe.generate_video(
        VIDEO_PROMPT, CONCEPTS, num_frames=VIDEO_FRAMES, height=VIDEO_H, width=VIDEO_W,
        num_inference_steps=STEPS_VIDEO, guidance_scale=6.0, return_cross_attention=True,
    ), counters)
    if launches != [per_run, 0, per_run]:
        raise AssertionError(
            f"generate_video (w8a8): launches [K1, K3, K1 hopper] {launches} != {[per_run, 0, per_run]}")
    grid = (len(CONCEPTS), VIDEO_FRAMES, VIDEO_H // cfg.patch_size, VIDEO_W // cfg.patch_size)
    for maps in (out.concept_heatmaps, out.cross_attention_maps):
        if maps.shape != grid or not np.isfinite(maps).all():
            raise AssertionError(f"bad w8a8 video heatmaps {maps.shape}, want {grid}")
    if not torch.isfinite(out.video_latents).all():
        raise AssertionError("non-finite w8a8 video latents")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"generate_video (w8a8) {VIDEO_FRAMES}x{VIDEO_H}x{VIDEO_W}, {STEPS_VIDEO} steps: "
          f"launches [K1, K3, K1 hopper] {launches}, init seconds {init_seconds:.3f}, "
          f"seconds {seconds:.4f}, "
          f"peak device memory GiB {peak:.3f}", flush=True)
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches[0]


def ring_path(counters, bf16_out, conv_per_decode, n=4):
    """flux-schnell with `attention_backend="ring_rdma"` over a virtual ring
    of `n` ranks on card 0 (random weights from init_seed 0, the bf16 run's
    weights): the ring reference checks, `generate_image` (1024x1024, STEPS
    steps) cold and warm, and `encode_image` cold and warm. Counters are
    [K4, K1, K2, K1 hopper, K2 hopper]; K4's step launches are read beside them. Returns
    {path: (launches, seconds)} of the warm runs."""
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.kernels.ring_rdma import ring_attention_rdma
    from conceptattention_torch.parallel import make_mesh

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = make_mesh(seq=n, devices=[torch.device("cuda", 0)] * n)
    pipe = ConceptAttentionFluxPipeline("flux-schnell", init_seed=0, attention_backend="ring_rdma",
                                        mesh=mesh)
    torch.cuda.synchronize()
    print(f"ring pipeline (seq={n} on card 0) init seconds {time.perf_counter() - t0:.3f}",
          flush=True)
    ring_reference_checks(pipe, mesh)
    cfg = pipe.cfg
    image = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    runs = {
        "generate_image (ring_rdma)": (lambda: pipe.generate_image(
            PROMPT, CONCEPTS, width=SIZE, height=SIZE, num_inference_steps=STEPS,
            return_pil_heatmaps=False, return_image_array=True),
            [STEPS * cfg.depth, 1, conv_per_decode, 1, conv_per_decode]),
        "encode_image (ring_rdma)": (lambda: pipe.encode_image(
            image, CONCEPTS, width=SIZE, height=SIZE, return_pil_heatmaps=False),
            [cfg.depth, 0, 0, 0, 0]),
    }
    paths = {}
    for label, (run, want) in runs.items():
        seconds = []
        for _ in range(2):
            before = ring_attention_rdma.step_launches
            out, secs, launches = counted(run, counters)
            steps = ring_attention_rdma.step_launches - before
            if launches != want or steps != n * want[0]:
                raise AssertionError(f"{label}: launches [K4, K1, K2, K1 hopper, K2 hopper] {launches} != {want}, "
                                     f"or K4 step launches {steps} != {n * want[0]}")
            check_image_output(out, label)
            seconds.append(secs)
        print(f"{label} {SIZE}x{SIZE}: launches [K4, K1, K2, K1 hopper, K2 hopper] {launches}, K4 step launches {steps}, "
              f"cold seconds {seconds[0]:.4f}, warm seconds {seconds[1]:.4f}", flush=True)
        paths[label] = (launches, seconds[1])
        if label.startswith("generate_image"):
            agreement = {tap: heatmap_agreement(getattr(out, tap), getattr(bf16_out, tap))
                         for tap in ("concept_heatmaps", "cross_attention_maps")}
            print(f"ring_rdma against the fused bf16 run, same weights, prompt and seed: "
                  f"{json.dumps(agreement)}", flush=True)  # a reading, no limit
    print(f"ring path peak device memory GiB {torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)
    # The single blocks' plain attention at their shape, as the pipeline runs
    # it (f32 matmuls in full f32): a reading beside K4's phases.
    from conceptattention_torch.ops.attention import sdpa
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    s = 256 + (SIZE // 16) ** 2
    gen = torch.Generator("cuda").manual_seed(10)
    q, k, v = (torch.randn(1, cfg.num_heads, s, cfg.head_dim, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    with _full_f32():
        single_ms = time_ms(lambda: sdpa(q, k, v))
    print(f"ring path single-block plain attention (sdpa, B1 H{cfg.num_heads} S={s} "
          f"D={cfg.head_dim}): {single_ms:.4f} ms a call, "
          f"{STEPS * cfg.depth_single_blocks} calls per generate_image", flush=True)
    del pipe, out, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def counted(run, counters):
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, [fn.launches for fn in counters]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}", flush=True)
    print(f"cuda {torch.version.cuda}", flush=True)
    print(gpu_line(), flush=True)

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.config import configs
    from conceptattention_torch.kernels import _build
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper
    from conceptattention_torch.kernels.flash_saliency import (
        fused_concept_flash_attention,
        fused_concept_flash_attention_hopper,
        fused_concept_flash_attention_int8,
        fused_concept_flash_attention_paired,
    )
    from conceptattention_torch.kernels.ring_rdma import ring_attention_rdma
    from conceptattention_torch.models.video.dit import cogvideox_5b_config

    t0 = time.perf_counter()
    logs = _build.build(["flash_saliency", "flash_saliency_sm90", "flash_saliency_int8", "conv3x3",
                         "conv3x3_sm90", "ring_attention"])
    print(f"build seconds {time.perf_counter() - t0:.3f}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "Performance Loss")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    spec = configs["flux-schnell"]
    cfg = spec.params
    # Exact-score K1 runs at batch 1 in generate_image (bf16, w8, w4: three
    # runs) and encode_image (bf16); the decodes (K1 at D=512 and K2) run
    # once per image: bf16, w8a8 + int8_qk, two of generate_images, w8, w4,
    # and the ring_rdma generate_image (whose DiT blocks take K4 and the
    # plain single-block attention).
    n_double = 3 * STEPS * cfg.depth + cfg.depth
    n_single = 3 * STEPS * cfg.depth_single_blocks
    decodes = 7
    flash = flash_phases(cfg, n_double, n_single, decodes)
    # K1b: generate_image (batch 1) and generate_images (batch 2) with w8a8
    # + int8_qk, and encode_image with int8_qk.
    int8 = int8_flash_phases(cfg, {
        "double": STEPS * cfg.depth + cfg.depth, "double b2": STEPS * cfg.depth,
        "single": STEPS * cfg.depth_single_blocks, "single b2": STEPS * cfg.depth_single_blocks})
    conv_counts = decoder_conv_shapes(spec.ae_params, SIZE // 8)
    conv = conv_phases(conv_counts, decodes)
    video_per_run = cogvideox_5b_config().num_layers * STEPS_VIDEO  # one generate_video
    # K1 in generate_video (bf16, PAIR_HEADS off) and in the w8a8 run
    video_k1, video_k3 = video_flash_phases(cogvideox_5b_config(), 2 * video_per_run,
                                            video_per_run)
    # K4 in the ring_rdma generate_image and encode_image (every double block)
    ring = ring_phases(cfg, cogvideox_5b_config(), STEPS * cfg.depth + cfg.depth)
    across = cross_card_ring_phase(cfg)
    ring += [across] if across else []
    torch.cuda.empty_cache()
    failed = [r["phase"] for r in flash + int8 + conv + video_k1 + video_k3 + ring if not r["ok"]]
    if failed:
        raise AssertionError(f"kernel phases outside their limits or with a blind control: {failed}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = ConceptAttentionFluxPipeline("flux-schnell", init_seed=0)
    torch.cuda.synchronize()
    print(f"pipeline init seconds {time.perf_counter() - t0:.3f}", flush=True)
    reference_checks(pipe)

    hopper = [fused_concept_flash_attention_hopper, conv3x3_same_hopper]
    counters = [fused_concept_flash_attention, conv3x3_same] + hopper
    per_image = STEPS * (cfg.depth + cfg.depth_single_blocks)
    # K1's Hopper instance takes every DiT block (head dim 128) and the VAE's
    # mid-attention (head dim 512)
    want_gen = [per_image + 1, sum(conv_counts.values()), per_image + 1, sum(conv_counts.values())]
    gen_seconds = []
    for _ in range(2):
        out, seconds, launches = counted(lambda: pipe.generate_image(
            PROMPT, CONCEPTS, width=SIZE, height=SIZE, num_inference_steps=STEPS,
            return_pil_heatmaps=False, return_image_array=True,
        ), counters)
        gen_seconds.append(seconds)
        if launches != want_gen:
            raise AssertionError(f"generate_image launches {launches} != {want_gen}")
        grid = SIZE // 16
        for maps in (out.concept_heatmaps, out.cross_attention_maps):
            if maps.shape != (len(CONCEPTS), grid, grid) or not np.isfinite(maps).all():
                raise AssertionError(f"bad heatmaps {maps.shape}")
        if out.image.shape != (SIZE, SIZE, 3) or out.image.dtype != np.uint8:
            raise AssertionError(f"bad image {out.image.shape} {out.image.dtype}")
    bf16_out = out
    print(f"generate_image {SIZE}x{SIZE} {STEPS} steps: launches {dict(zip(['flash_saliency', 'conv3x3'], want_gen))}, "
          f"cold seconds {gen_seconds[0]:.4f}, warm seconds {gen_seconds[1]:.4f}", flush=True)

    image = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    enc_seconds = []
    for _ in range(2):
        out, seconds, launches = counted(lambda: pipe.encode_image(
            image, CONCEPTS, width=SIZE, height=SIZE, return_pil_heatmaps=False,
        ), counters)
        enc_seconds.append(seconds)
        if launches != [cfg.depth, 0, cfg.depth, 0]:
            raise AssertionError(f"encode_image launches {launches} != {[cfg.depth, 0, cfg.depth, 0]}")
        for maps in (out.concept_heatmaps, out.cross_attention_maps):
            if maps.shape != (len(CONCEPTS), grid, grid) or not np.isfinite(maps).all():
                raise AssertionError(f"bad heatmaps {maps.shape}")
    print(f"encode_image {SIZE}x{SIZE}: launches {{'flash_saliency': {cfg.depth}}}, "
          f"cold seconds {enc_seconds[0]:.4f}, warm seconds {enc_seconds[1]:.4f}", flush=True)
    print(f"peak device memory GiB {torch.cuda.max_memory_allocated() / 2**30:.3f}", flush=True)
    names = ["flash_saliency", "conv3x3", "flash_saliency (Hopper instance)", "conv3x3 (Hopper instance)"]
    print("launches per kernel instance: " + json.dumps({
        "generate_image": dict(zip(names, want_gen)),
        "encode_image": dict(zip(names, [cfg.depth, 0, cfg.depth, 0]))}), flush=True)
    int8_counters = [fused_concept_flash_attention, fused_concept_flash_attention_int8,
                     conv3x3_same] + hopper
    quant_paths = quantized_flux_path(pipe, bf16_out, int8_counters, want_gen[1])
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()
    quant_paths.update(random_quantized_paths(int8_counters, want_gen[1]))
    # one run of each path: the warm generate_images stands for it
    quant_paths = {k.replace(" warm", ""): v[0] for k, v in quant_paths.items() if "cold" not in k}
    ring_paths = ring_path([ring_attention_rdma, fused_concept_flash_attention, conv3x3_same] + hopper,
                           bf16_out, want_gen[1])
    del bf16_out

    video_counters = [fused_concept_flash_attention, fused_concept_flash_attention_paired,
                      fused_concept_flash_attention_hopper]
    video_summary = video_path(video_counters)
    print(f"generate_video summary {json.dumps(video_summary)}", flush=True)
    video_k1_w8a8 = quantized_video_path(video_counters)
    video_k1_bf16 = video_summary["ddim warm"]["launches [K1, K3, K1 hopper]"][0]
    video_k3_paired = video_summary["ddim heads paired"]["launches [K1, K3, K1 hopper]"][1]

    def entry(name, source, replaces, launches, phases, per_path, **more):
        on_path = [r for r in phases if r["main_path_launches"]]
        if sum(r["main_path_launches"] for r in on_path) != launches:
            raise AssertionError(f"{name}: per-shape launches do not add up to {launches}")

        def total(key):
            vals = [(r["main_path_launches"], r[key]) for r in on_path]
            return None if any(x is None for _, x in vals) else sum(n * x for n, x in vals)

        ops_ms = sum(r["main_path_launches"] * r["bound_ms"] for r in on_path if r["bound_by"] == "operations")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in phases),
            "err_over_limit": max(r["err_over_limit"] for r in phases),
            "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if 2 * ops_ms >= total("bound_ms") else "bytes",
            "library_ms": total("library_ms"),
            "launches_per_path": per_path,
            **more,
            "ms_basis": "per main paths (one run of each path in launches_per_path): "
                        "sum over shapes of launches x median ms; kernel and library on the "
                        "full shape, plain on the head subset at the video shape (plain_basis)",
            "phases": phases,
        }

    def per_path(i, base):
        """{path: launches} of counter i over the base paths and the quantized ones."""
        out = dict(base, **{k: v[i] for k, v in quant_paths.items() if v[i]})
        return out, sum(out.values())

    ring_gen = ring_paths["generate_image (ring_rdma)"][0]  # [K4, K1, K2, K1 hopper, K2 hopper]
    k1_paths, k1_total = per_path(0, {
        "generate_image": want_gen[0], "encode_image": cfg.depth,
        "generate_video (PAIR_HEADS off)": video_k1_bf16, "generate_video (w8a8)": video_k1_w8a8,
        "generate_image (ring_rdma)": ring_gen[1]})
    k1b_paths, k1b_total = per_path(1, {})
    k2_paths, k2_total = per_path(2, {"generate_image": want_gen[1],
                                      "generate_image (ring_rdma)": ring_gen[2]})
    k4_paths = {label: launches[0] for label, (launches, _) in ring_paths.items()}
    kernels = [
        entry("flash_saliency", "conceptattention_torch/csrc/flash_saliency_sm90.cu",
              "conceptattention_tpu/kernels/flash_saliency.py:305", k1_total, flash + video_k1,
              k1_paths, instances={
                  "conceptattention_torch/csrc/flash_saliency_sm90.cu":
                      "head dims 64, 128, 512 (Hopper)",
                  "conceptattention_torch/csrc/flash_saliency.cu":
                      "head dim 32 (mma.sync; its 64, 128, 512 instances timed as mma_sync_ms)"},
              hopper_launches_per_path={
                  "generate_image": want_gen[2], "encode_image": cfg.depth,
                  "generate_video (PAIR_HEADS off)":
                      video_summary["ddim warm"]["launches [K1, K3, K1 hopper]"][2],
                  "generate_video (w8a8)": video_k1_w8a8,
                  "generate_image (ring_rdma)": ring_gen[3],
                  **{k: v[3] for k, v in quant_paths.items() if v[3]}}),
        entry("flash_saliency_paired", "conceptattention_torch/csrc/flash_saliency.cu",
              "conceptattention_tpu/kernels/flash_saliency.py:670", video_k3_paired, video_k3,
              {"generate_video (PAIR_HEADS on)": video_k3_paired}),
        entry("conv3x3", "conceptattention_torch/csrc/conv3x3_sm90.cu",
              "conceptattention_tpu/kernels/conv3x3.py:91", k2_total, conv, k2_paths, instances={
                  "conceptattention_torch/csrc/conv3x3_sm90.cu": "bf16, Cin % 64 == 0 (Hopper)",
                  "conceptattention_torch/csrc/conv3x3.cu": "f32, other bf16 channel counts"},
              hopper_launches_per_path={"generate_image": want_gen[3],
                                        "generate_image (ring_rdma)": ring_gen[4],
                                        **{k: v[4] for k, v in quant_paths.items() if v[4]}}),
        entry("flash_saliency_int8", "conceptattention_torch/csrc/flash_saliency_int8.cu",
              "conceptattention_tpu/kernels/flash_saliency.py:305 (int8_qk)", k1b_total, int8,
              k1b_paths),
        entry("ring_attention", "conceptattention_torch/csrc/ring_attention.cu",
              "conceptattention_tpu/kernels/ring_rdma.py:215", sum(k4_paths.values()), ring,
              k4_paths),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
