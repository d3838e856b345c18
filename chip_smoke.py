#!/usr/bin/env python3
"""Drive the PyTorch port (`conceptattention_torch`) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. In order it
1. prints the torch and CUDA versions and the card's name and power limit;
2. builds every kernel from `conceptattention_torch/csrc` (one nvcc per
   source, started together);
3. holds each kernel against its plain PyTorch version in bf16 at the main
   paths' shapes, the flux-dev blocks (S=4611, 4608), the batched
   encode's (B=2, 4), the NHWC encoder's convs, the eval path's double
   block (512x512: S=1286 at B=1 and 4 in the four cross / self modes, and
   7 and 8 concepts) and the sweeps' (512x512 with 4 concepts: S=1284 with
   flux-schnell's 256 txt rows, S=1540 with flux-dev's 512) and the
   qualitative comparison's (512x512 with 3 concepts, S=1283) included
   (attention per
   row segment, each against its own scale;
   K1b, the int8-score attention, also against K1 and its pre-pass against
   the plain quantizer;
   at the CogVideoX shape the plain version runs on a subset of heads of
   the full-shape launch; K4, the ring kernel, on a virtual ring of 4 ranks
   on card 0, and on a ring of 2 across cards 0 and 1 where there are two),
   shows with planted controls (the plain version with one fault) that each
   limit sees such a fault, and times kernel, plain version and one library
   call that computes the same function (the port never calls it); where a
   redesigned Hopper instance took over a shape (K1 at head dims 64, 128 and
   512, K1b at head dim 128, K2 in bf16, K3, K4 at head dims 64 and 128),
   the earlier kernel's time on the same input is read beside it; K1b also
   reads its pre-pass alone; K4 also reads its N step
   launches alone (no hops) and checks its f32 running state against the
   plain step after every step but the last;
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
   its blocks quantized to w8a8; `encode_images` at batch 2 and 4 on the
   flux-schnell weights against the same images' `encode_image` calls, and
   on the same pipeline the segmentation eval path at the ImageNet-Seg
   harness's protocol (512x512, layers 14-17): the Flux tap models on the
   fused backend against the sdpa backend, `segment_batch` against
   per-image calls, `per_layer_coefficients` against one-layer calls, the
   concept basis against the output map, the ImageNet harness functions at
   batch 1 and 4 over images held in memory (timed, with a breakdown), and
   the VOC multi-class runner; the per-layer sweep over those images (its
   rows against one-layer models' scores); the ViT family at full width
   with random weights (the 8 ViT-B/16 baselines, TextSpan over ViT-B and
   over open_clip ViT-H/14: the card's f32 maps against the CPU's) and the
   ImageNet harness with four of them; the SD2-base and SDXL-base UNets at
   full width (random weights, f32) at latent 32 and 64, eps and every
   cross-attention map against the CPU's run, with planted controls, and
   DAAMSD2 / DAAMSDXL through the ImageNet harness functions; the
   perturbation test (ViT-B/16, 7 Chefer methods, positive and negative, 9
   steps: the experiment's `run` timed per method, and the card's accuracies
   against the CPU's with the relevance methods in f64, a tie-order control
   beside); and `compare_methods.main` over all 15 segmentation methods on
   one 512x512 image with 3 concepts (its 4 flux methods on the flux-schnell
   pipeline, K1 counted);
   then, with every earlier pipeline released, the T5-XXL and CLIP-L text
   towers from random HF state dicts through the port's converters (bf16
   against f32 at 2 layers, timed), flux-dev `generate_image` (1024x1024,
   4 steps, guidance 3.5) through `TorchTextEncoders` cold and warm, its
   image-to-image at strength 0.5, the watermark read back from its image,
   the NHWC encoder against the NCHW one (and the NCHW decoder against the
   NHWC one), the per-timestep sweep (50-step schedule, timesteps 0, 25, 45,
   its sigmas against the schedule written out), and the checkpoint path: a flux-dev-shaped `.safetensors`
   checkpoint cut to 2 double and 4 single blocks and the full VAE, written
   under build/ and loaded by the pipeline in bf16 (bit for bit) and w8a8
   (device peak below the bf16 tree); every kernel's launch count (and the
   Hopper instances', which take K1 at head dims 64, 128 and 512, K1b at
   head dim 128, K3, and K4's steps at head dims 64 and 128) is set to 0
   just before and read just after each run;
6. prints the Hopper instances' launches on the bf16 `generate_image` and
   `encode_image`, one `kernels` JSON line, then the result line.
The ptxas register and spill lines of every kernel and a summary of the
Hopper libraries' SASS (instructions, I2F conversions and a digest per
kernel, from `cuobjdump -sass`) are printed after the build.
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
# The counters read on the flux paths that may take K1b, in this order.
INT8_COUNTERS = "[K1, K1b, K2, K1 hopper, K2 hopper, K1b hopper]"
# The sources of the redesigned (Hopper) kernels, summarised from their SASS.
HOPPER_SOURCES = ("flash_saliency_sm90", "flash_saliency_int8_sm90", "conv3x3_sm90",
                  "ring_attention_sm90")


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


def host_ms(fn, reps: int = 7) -> float:
    """Median host time to enqueue one call of `fn`, from an idle card (no
    synchronise inside the timed span): where it reaches the call's event
    time, the host, not the card, sets the call's pace."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
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


def paired_readings(args):
    """Readings beside a K3 phase: the mma.sync two-heads-per-block kernel
    (`csrc/flash_saliency.cu`, which took K3 before the Hopper instance) and
    K1 (its Hopper instance, the same function head by head) on the same
    input, both launched directly, uncounted."""
    from conceptattention_torch.kernels import flash_saliency as fs

    def extra(got):
        return {"mma_sync_ms": time_ms(lambda: fs._launch("ca_flash_saliency_paired_bf16", *args)),
                "k1_ms": time_ms(lambda: fs._launch_sm90("ca_flash_saliency_sm90_bf16", *args))}
    return extra


def flash_phases(cfg, main_double, main_single, main_vae):
    from conceptattention_torch.kernels import flash_saliency as fs

    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(1)
    h, d = cfg.num_heads, cfg.head_dim

    def qkv(b, heads, s, dim):
        q, k, v = (torch.randn(b, heads, s, dim, generator=gen, device=dev) for _ in range(3))
        return (Q_SCALE * q).bfloat16(), k.bfloat16(), v.bfloat16()

    def pairs(s, *seg, cross=True, self_attention=True):
        return fs.segment_mask(s, *seg, cross, self_attention, dev).sum().item()

    results = []
    (q, k, v, t, p, c, _, _, cos, sin), qr, kr = joint_rows_inputs(cfg, gen, 1, 256)
    s = t + p + c
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

    args, qs, ks = single_rows_inputs(cfg, gen, 256)
    s = args[3]
    results.append(phase_result(
        f"flash_saliency single_block S={s}",
        lambda: fs.fused_concept_flash_attention(*args),
        lambda: fs.fused_concept_flash_attention_plain(*args),
        lambda: F.scaled_dot_product_attention(qs, ks, args[2]),
        4 * d * s * s * h, 4 * h * s * d * 2 + 2 * s * d * 4, main_single,
        controls=[("one key tile dropped", "all", lambda want: drop_key_tile(want, args, 256 + 64 * 32))],
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
    values where the pre-pass and the plain quantizer differ (must be 0);
    the mma.sync K1b (`csrc/flash_saliency_int8.cu`, which took head dim 128
    before the Hopper instance) on the same input, launched directly,
    uncounted; and the pre-pass alone.
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
                    "mma_sync_ms": time_ms(lambda: fs._launch_int8("ca_flash_saliency_int8",
                                                                   *args)),
                    "prepass_ms": time_ms(lambda: fs.quantize_qk_rows_cuda(
                        args[0], args[1], *args[-2:])),
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
            f"flash_saliency_paired (hopper) video {tag}",
            lambda a=(q, k, v, cos, sin, t, p, c, cross, self_attention):
                fs.fused_concept_flash_attention_paired(*a),
            lambda a=(qs, ks, vs, cs, ss, t, p, c, cross, self_attention):
                fs.fused_concept_flash_attention_paired_plain(*a),
            library, *cost, launches_k3 if on_path else 0, **common,
            extra=paired_readings(full_args),
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


def state_readings(acc, ml, want, v):
    """The Hopper step kernel's f32 running state against `ring_step_plain`'s:
    each error over its limit (the max within 1e-4 of 1 + |max|, f32 sums in
    another order; the sum within 1e-3 of itself, an approximate exp2; acc
    within 2^-7 of sum x max|v|, each term's bf16 P at most one step apart)
    and whether the same rows are empty (max -inf, sum 0, acc 0)."""
    want_acc, want_ml = want
    m, l, wm, wl = ml[..., 0], ml[..., 1], want_ml[..., 0], want_ml[..., 1]
    empty = torch.isinf(wm)
    same_empty = (torch.equal(torch.isinf(m), empty) and bool((m[empty] < 0).all())
                  and torch.count_nonzero(l[empty]).item() == 0
                  and torch.count_nonzero(acc[empty]).item() == 0)
    seen = ~empty

    def ratio(err, lim):
        return (err / lim)[seen].max().item() if bool(seen.any()) else 0.0

    acc_lim = (2.0**-7 * wl[..., None] * v.float().abs().max()).clamp_min(1e-30)
    return {"max": ratio((m - wm).abs(), 1e-4 * (1 + wm.abs())),
            "sum": ratio((l - wl).abs(), 1e-3 * wl),
            "acc": ((acc - want_acc).abs() / acc_lim)[seen[..., None].expand_as(acc)].max().item()
            if bool(seen.any()) else 0.0,
            "same_empty_rows": same_empty}


def ring_state_check(qs, ks, vs, segments, masked_kw):
    """The Hopper step kernel launched step by step (uncounted) on the
    ranks' shards, each rank given the chunk it holds: after each of steps
    0..N-2 its state against `ring_step_plain` (`state_readings`), worst
    over ranks and steps. Control: the plain state of step 1 with the chunk
    origin one step off must break the acc limit."""
    from conceptattention_torch.kernels import ring_rdma as rr

    n = len(qs)
    accs = [torch.empty(q.shape, device=q.device) for q in qs]
    mls = [torch.empty((*q.shape[:3], 2), device=q.device) for q in qs]
    outs = [torch.empty_like(q) for q in qs]
    plain, worst, control = [None] * n, {"max": 0.0, "sum": 0.0, "acc": 0.0}, 0.0
    same_empty = True
    for step in range(n - 1):
        held = [(r - step) % n for r in range(n)]
        rr._launch_step("hopper", qs, [ks[i] for i in held], [vs[i] for i in held], accs, mls,
                        outs, list(range(n)), n, step, segments)
        torch.cuda.synchronize()
        for my in range(n):
            before = plain[my]
            plain[my] = rr.ring_step_plain(qs[my], ks[held[my]], vs[held[my]], before, my, step, n,
                                           **masked_kw)
            got = state_readings(accs[my], mls[my], plain[my], vs[held[my]])
            same_empty = same_empty and got.pop("same_empty_rows")
            worst = {key: max(worst[key], got[key]) for key in worst}
            if step == 1:
                off = (held[my] - 1) % n
                wrong = rr.ring_step_plain(qs[my], ks[off], vs[off], before, my, step, n, **masked_kw)
                control = max(control, state_readings(wrong[0], wrong[1], plain[my],
                                                      vs[held[my]])["acc"])
    ok = same_empty and max(worst.values()) <= 1.0 and control > 1.0
    return {"state_check": {"err_over_limit": worst, "same_empty_rows": same_empty,
                            "control: chunk origin off by one step, acc err_over_limit": control,
                            "ok": ok}}


def ring_phases(cfg, vcfg, launches, n=4):
    """K4 on a virtual ring of `n` ranks on card 0, against its plain
    version (the "ring" backend's ring on the same mesh): the flux double
    block (B1 H24 D128, S = 256 + 4096 + 3 padded to a multiple of n) in all
    four ablations, and the CogVideoX-5b block (B2 H48 D64, S = 226 + 17550
    + 226 padded), whose plain version runs on 4 of the 96 (batch, head)
    rows as K1's video phase does. Both head dims take the Hopper step
    kernel. Rows are held per segment; the pad rows' limit is 0 (they must
    be exact zeros). Controls: the plain ring with the chunk origin one step
    off, with one hop skipped, and with the self_attention flag flipped.
    Readings beside the call's time (shard copies, hops, step launches,
    concatenation): the host's time to enqueue one call (`call_host_ms`),
    the N step launches alone on the same shards (`steps_ms`), the mma.sync
    kernel (`csrc/ring_attention.cu`, which took
    these head dims before) in the whole call and in its step launches
    alone, K1 on the same fused input (unsharded), the bytes the hops move,
    the step launches of one call and the Hopper ones, and, on the path's
    ablation, the per-step state check (`ring_state_check`). The library
    call is masked SDPA over the unsharded sequence."""
    from functools import partial

    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels import ring_rdma as rr
    from conceptattention_torch.models.video.dit import make_video_ids
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import embed_nd
    from conceptattention_torch.parallel import make_mesh
    from conceptattention_torch.parallel.ring_attention import (
        make_ring_concept_attention,
        shard_over_ring,
    )

    dev = "cuda"
    mesh = make_mesh(seq=n, devices=[torch.device(dev, 0)] * n)
    gen = torch.Generator(dev).manual_seed(8)

    def shards(x):
        lc = x.shape[2] // n
        return [x[:, :, r * lc:(r + 1) * lc].contiguous() for r in range(n)]

    def steps_only(instance, qs, ks, vs, segments):
        """The N step launches of one ring on pre-placed chunks, no hops."""
        accs = [torch.empty(q.shape, device=q.device) for q in qs]
        mls = [torch.empty((*q.shape[:3], 2), device=q.device) for q in qs]
        outs = [torch.empty_like(q) for q in qs]

        def run():
            for step in range(n):
                held = [(r - step) % n for r in range(n)]
                rr._launch_step(instance, qs, [ks[i] for i in held], [vs[i] for i in held], accs,
                                mls, outs, list(range(n)), n, step, segments)
        return run

    def readings(fused, padded, state_shards, t, p, c, cross, self_attention):
        segments = (t, p, c, cross, self_attention)
        masked_kw = dict(masked=True, txt_len=t, img_len=p, concept_len=c, cross=cross,
                         self_attention=self_attention)
        old_call = shard_over_ring(mesh, "seq", lambda qs, ks, vs: rr._run_ring(
            qs, ks, vs, segments, partial(rr._launch_step, "mma_sync")))
        call = rr.make_ring_concept_attention_rdma(mesh, "seq", t, p, c, cross, self_attention)

        def extra(got):
            counts = (rr.ring_attention_rdma.step_launches, rr.ring_attention_rdma.hopper_step_launches)
            call(*padded)
            steps = rr.ring_attention_rdma.step_launches - counts[0]
            hopper_steps = rr.ring_attention_rdma.hopper_step_launches - counts[1]
            qs, ks, vs = (shards(x) for x in padded)
            b, h, s_pad, d = padded[0].shape
            out = {"call_host_ms": host_ms(lambda: call(*padded)),
                   "steps_ms": time_ms(steps_only("hopper", qs, ks, vs, segments)),
                   "mma_sync_ms": time_ms(lambda: old_call(*padded)),
                   "mma_sync_steps_ms": time_ms(steps_only("mma_sync", qs, ks, vs, segments)),
                   "k1_ms": time_ms(lambda: fs.fused_concept_flash_attention(
                       *fused, t, p, c, cross, self_attention)),
                   # N - 1 hops of every rank's bf16 K and V chunk
                   "hop_bytes_per_call": (n - 1) * 2 * b * h * s_pad * d * 2,
                   "step_launches_per_call": steps, "hopper_step_launches_per_call": hopper_steps}
            del qs, ks, vs
            ok = steps == hopper_steps == n
            if state_shards is not None:
                out.update(ring_state_check(*state_shards, segments, masked_kw))
                ok = ok and out["state_check"]["ok"]
            out["ok"] = ok
            return out
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
        on_path = cross and self_attention
        results.append(phase_result(
            f"ring_attention (hopper) double_block B=1 H={h} D={d} S={s}->{s_pad} N={n} "
            f"cross={cross} self={self_attention}",
            lambda a=(cross, self_attention): rr.make_ring_concept_attention_rdma(
                mesh, "seq", t, p, c, *a)(*padded),
            lambda a=(cross, self_attention): make_ring_concept_attention(
                mesh, "seq", t, p, c, *a)(*padded),
            lambda m=mask: F.scaled_dot_product_attention(fused[0], fused[1], fused[2], attn_mask=m),
            4 * d * n_pairs * h, 4 * h * s * d * 2,
            launches if on_path else 0, segments(t, p, c, s_pad), controls,
            extra=readings(fused, padded, split if on_path else None, t, p, c, cross,
                           self_attention),
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
        f"ring_attention (hopper) video B={b} H={h} D={d} S={s}->{s_pad} N={n} cross=True self=True",
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
        plain_basis=f"head subset: batch row 1, heads 0, 1, {h - 2}, {h - 1} of {b} x {h} "
                    f"(the per-step state check on the same subset)",
        extra=readings(fused, padded, split, t, p, c, True, True),
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


def conv_phases(launch_counts: Counter):
    """K2 at every decoder and encoder shape the gate admits (and one with
    swish), `launch_counts` {(H, Cin, Cout): main-path launches}: the Hopper
    instance against the plain version, with the generic kernel
    (`csrc/conv3x3.cu`, which took these shapes before it) timed beside it."""
    from conceptattention_torch.kernels.conv3x3 import (
        conv3x3_instance,
        conv3x3_same,
        conv3x3_same_generic,
        conv3x3_same_plain,
    )

    gen = torch.Generator("cuda").manual_seed(2)
    results = []
    cases = [(shape, False) for shape in sorted(launch_counts)] + [(min(launch_counts), True)]
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
            raise AssertionError(f"conv {res}x{res} {cin}->{cout} would not take the Hopper K2")
        results.append(phase_result(
            f"conv3x3 H=W={res} Cin={cin} Cout={cout} swish={swish}",
            lambda: conv3x3_same(x, w, b, swish), lambda: conv3x3_same_plain(x, w, b, swish),
            library, 2 * res * res * cout * 9 * cin,
            2 * (res * res * (cin + cout) + 9 * cin * cout + cout),
            0 if swish else launch_counts[(res, cin, cout)],
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
    [K1, K1b, K2, K1 hopper, K2 hopper, K1b hopper]. Returns {path:
    (launches, seconds)}."""
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
            raise AssertionError(f"{label}: launches {INT8_COUNTERS} {launches} != {want}")
        for o in out if isinstance(out, list) else [out]:
            check_image_output(o, label)
        print(f"{label}: launches {INT8_COUNTERS} {launches}, seconds {seconds:.4f}", flush=True)
        paths[label] = (launches, seconds)
        return out

    one = run("generate_image (w8a8, int8_qk, same weights)",
              lambda: qpipe.generate_image(PROMPT, CONCEPTS, **gen_kw),
              [1, per_image, conv_per_decode, 1, conv_per_decode, per_image])
    agreement = {tap: heatmap_agreement(getattr(one, tap), getattr(bf16_out, tap))
                 for tap in ("concept_heatmaps", "cross_attention_maps")}  # a reading, no limit
    print(f"w8a8 + int8_qk against bf16, same weights, prompt and seed: {json.dumps(agreement)}",
          flush=True)
    for label in ("cold", "warm"):
        outs = run(f"generate_images (w8a8, int8_qk, batch 2) {label}",
                   lambda: qpipe.generate_images([PROMPT] * 2, CONCEPTS, seeds=[0, 1], **gen_kw),
                   [2, per_image, 2 * conv_per_decode, 2, 2 * conv_per_decode, per_image])
    seed0 = {"concept_heatmaps max abs diff": float(np.abs(
        outs[0].concept_heatmaps - one.concept_heatmaps).max())}
    print(f"generate_images seed 0 against generate_image seed 0: {json.dumps(seed0)}", flush=True)
    image = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    enc = run("encode_image (int8_qk)", lambda: qpipe.encode_image(
        image, CONCEPTS, width=SIZE, height=SIZE, return_pil_heatmaps=False),
        [0, cfg.depth, 0, 0, 0, cfg.depth])
    del enc
    return paths


def random_quantized_paths(counters, conv_per_decode):
    """flux-schnell with random already-quantized weights (`quantize="w8"`
    and `"w4"`): init, then one `generate_image`. Counters are INT8_COUNTERS."""
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
        want = [per_image + 1, 0, conv_per_decode, per_image + 1, conv_per_decode, 0]
        out, seconds, launches = counted(lambda: pipe.generate_image(
            PROMPT, CONCEPTS, width=SIZE, height=SIZE, num_inference_steps=STEPS,
            return_pil_heatmaps=False, return_image_array=True), counters)
        if launches != want:
            raise AssertionError(f"generate_image ({mode}): launches {launches} != {want}")
        check_image_output(out, f"generate_image ({mode})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"generate_image ({mode}, random quantized init) {SIZE}x{SIZE} {STEPS} steps: "
              f"launches {INT8_COUNTERS} {launches}, init seconds {init_seconds:.3f}, "
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
            before = (ring_attention_rdma.step_launches, ring_attention_rdma.hopper_step_launches)
            out, secs, launches = counted(run, counters)
            steps = ring_attention_rdma.step_launches - before[0]
            hopper_steps = ring_attention_rdma.hopper_step_launches - before[1]
            # every step of the DiT's head dim 128 goes through the Hopper step kernel
            if launches != want or not steps == hopper_steps == n * want[0]:
                raise AssertionError(f"{label}: launches [K4, K1, K2, K1 hopper, K2 hopper] {launches} != {want}, "
                                     f"or K4 step launches {steps} (Hopper {hopper_steps}) != {n * want[0]}")
            check_image_output(out, label)
            seconds.append(secs)
        print(f"{label} {SIZE}x{SIZE}: launches [K4, K1, K2, K1 hopper, K2 hopper] {launches}, K4 step launches {steps} "
              f"(Hopper instance {hopper_steps}), "
              f"cold seconds {seconds[0]:.4f}, warm seconds {seconds[1]:.4f}", flush=True)
        paths[label] = (launches, seconds[1], hopper_steps)
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


# ----------------------------------------------------------------------------
# The flux pipeline's remaining surface: K1 at the new shapes, the batched
# encode, the text towers, flux-dev, image-to-image, the NHWC encoder, the
# checkpoint path and the watermark.
# ----------------------------------------------------------------------------

# bf16 towers (2 layers, full width) against the same towers in f32, relative
# RMS of the T5 hidden states and of the CLIP pooled vector: bf16 rounds each
# matmul input and output to 8 bits of mantissa (2^-9 relative) through two
# blocks of a few matmuls each, a few tenths of a percent; the controls (T5
# v1.0's ReLU in the gated FFN, CLIP pooled at the last token) move the
# output by tens of percent.
TEXT_TOWER_LIMIT = 2.0**-5
# encode_images against the same images' encode_image calls, relative RMS of
# each image's concept and cross-attention heatmaps. At batch 1 the two are
# the same launches on the same inputs and must agree bit for bit. At batch 2
# and 4 the encoder still takes one image at a time (the same latents), but
# the DiT's bf16 GEMMs round in another order than at batch 1, and the
# random-weight DiT's peaked softmax over the concepts turns that into
# 3.0-3.5% RMS of the heatmaps (0.030-0.035 on an H100 80GB HBM3 at 700 W);
# the limit is about twice that. The control, one image encoded with another
# image's seed, reads about 0.70. The witness that the gap is rounding: the
# same comparison on the plain attention ("sdpa", no kernel) in bf16 at full
# depth (0.031-0.036), and at ENCODE_WITNESS_DEPTH double blocks in bf16
# (0.011) and in f32 (7.5e-6 to 8.2e-6), where rounding is 2^-15 of bf16's
# (same card). The f32 reading is held to ENCODE_IMAGES_F32_LIMIT: a
# per-image fault of the batched path at a hundredth of a percent would
# cross it.
ENCODE_IMAGES_LIMIT = 2.0**-4
ENCODE_IMAGES_F32_LIMIT = 2.0**-14
ENCODE_WITNESS_DEPTH = 4
# bf16 NHWC encoder / decoder (kernels) against the f32 NCHW one (F.conv2d),
# relative RMS: bf16 rounding through about 30 conv layers, as the reference
# VAE decode check; the control skips the mid-attention block.
VAE_LAYOUT_LIMIT = 5e-2


def np_rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want**2).mean()))


def joint_rows_inputs(cfg, gen, b, t, dev="cuda", size=SIZE, c=len(CONCEPTS)):
    """A double block's attention inputs at `size` with `t` txt rows and `c`
    concept rows, batch `b`: K1's args, and the roped q and k for the
    library call."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import apply_rope, embed_nd

    h, d = cfg.num_heads, cfg.head_dim
    grid = size // 16
    p = grid * grid
    s = t + p + c
    img_ids = make_img_ids(grid, grid, b, device=dev)
    pe = embed_nd(torch.cat([torch.zeros(b, t, 3, device=dev), img_ids], 1), cfg.axes_dim, cfg.theta)
    cpe = embed_nd(torch.cat([torch.zeros(b, c, 3, device=dev), img_ids], 1), cfg.axes_dim, cfg.theta)
    cpe = (cpe[0][:, :, :c], cpe[1][:, :, :c])
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (Q_SCALE * q).bfloat16(), k.bfloat16(), v.bfloat16()
    # Each concept key points along its own query, 4 units long. Its score
    # (about 4 sigma, concept positions rotate by the identity) competes with
    # the strongest img key's, so the concept rows' cross and self terms both
    # carry weight.
    qc = q[:, :, t + p:].float()
    k[:, :, t + p:] = (4.0 * qc / qc.norm(dim=-1, keepdim=True)).bfloat16()
    cos, sin = fs.expand_rope_tables([pe, cpe], s)
    qj, kj = apply_rope(q[:, :, :t + p], k[:, :, :t + p], pe)
    qc, kc = apply_rope(q[:, :, t + p:], k[:, :, t + p:], cpe)
    return (q, k, v, t, p, c, True, True, cos, sin), torch.cat([qj, qc], 2), torch.cat([kj, kc], 2)


def single_rows_inputs(cfg, gen, t, dev="cuda"):
    """A single block's attention inputs at SIZE with `t` txt rows (one
    segment, as the single blocks call K1): K1's args, and the roped q and k
    for the library call."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.ops.rope import apply_rope, embed_nd

    grid = SIZE // 16
    s = t + grid * grid
    img_ids = make_img_ids(grid, grid, 1, device=dev)
    pe = embed_nd(torch.cat([torch.zeros(1, t, 3, device=dev), img_ids], 1), cfg.axes_dim, cfg.theta)
    q, k, v = (torch.randn(1, cfg.num_heads, s, cfg.head_dim, generator=gen, device=dev)
               for _ in range(3))
    q, k, v = (Q_SCALE * q).bfloat16(), k.bfloat16(), v.bfloat16()
    cos, sin = fs.expand_rope_tables([pe], s)
    qs, ks = apply_rope(q, k, pe)
    return (q, k, v, s, 0, 0, True, True, cos, sin), qs, ks


def new_shape_flash_phases(cfg, launches):
    """K1 at the shapes the flux-dev paths and `encode_images` give it: the
    flux-dev double block (512 txt rows, S=4611) and single block (S=4608)
    at batch 1, and the flux-schnell double block (S=4355) at batch 2 and 4.
    `launches` is {phase key: main-path launches}."""
    from conceptattention_torch.kernels import flash_saliency as fs

    gen = torch.Generator("cuda").manual_seed(4)
    h, d = cfg.num_heads, cfg.head_dim
    results = []
    for key, b, t in (("dev double", 1, 512), ("double b2", 2, 256), ("double b4", 4, 256)):
        args, qr, kr = joint_rows_inputs(cfg, gen, b, t)
        _, _, v, t, p, c, *_ = args
        s = t + p + c
        mask = fs.segment_mask(s, t, p, c, True, True, "cuda")
        controls = [
            ("cross flipped", "concept rows",
             lambda _, a=args: fs.fused_concept_flash_attention_plain(*a[:6], False, *a[7:])),
            ("one img key tile dropped", "joint rows",
             lambda want, a=args: drop_key_tile(want, a, a[3] + 64 * 32)),
        ]
        label = "flux-dev double_block" if key == "dev double" else f"double_block B={b}"
        results.append(phase_result(
            f"flash_saliency {label} S={s}",
            lambda a=args: fs.fused_concept_flash_attention(*a),
            lambda a=args: fs.fused_concept_flash_attention_plain(*a),
            lambda m=mask, qr=qr, kr=kr, v=v: F.scaled_dot_product_attention(qr, kr, v, attn_mask=m),
            b * 4 * d * mask.sum().item() * h, b * (4 * h * s * d * 2 + 2 * s * d * 4),
            launches[key], {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)},
            controls,
        ))
        del args, qr, kr, mask
        torch.cuda.empty_cache()

    args, qs, ks = single_rows_inputs(cfg, gen, 512)
    s = args[3]
    results.append(phase_result(
        f"flash_saliency flux-dev single_block S={s}",
        lambda: fs.fused_concept_flash_attention(*args),
        lambda: fs.fused_concept_flash_attention_plain(*args),
        lambda: F.scaled_dot_product_attention(qs, ks, args[2]),
        4 * d * s * s * h, 4 * h * s * d * 2 + 2 * s * d * 4, launches["dev single"],
        controls=[("one key tile dropped", "all", lambda want: drop_key_tile(want, args, 512 + 64 * 32))],
    ))
    return results


# The segmentation eval path at the ImageNet-Seg harness's protocol: 512^2
# input (256 txt + 1024 img rows), 4 steps, noise step 2, layers 14-17, the
# target and five background concepts (C = 6).
EVAL_SIZE = 512
EVAL_LAYERS = [14, 15, 16, 17]
EVAL_TARGET = "dog"
EVAL_IMAGES = 8
EVAL_BATCH = 4
# DAAMFlux takes the caption's words as its concepts: C = 8.
EVAL_DAAM_CAPTION = "a brown dog sleeps on green grass outside"
# The VOC multi-class runner's images: 5 background concepts and the classes
# present, C = 6 or 7.
EVAL_VOC_PRESENT = [["dog"], ["cat", "sofa"], ["bird"], ["horse"]]
CROSS_SELF_MODES = [(True, True), (True, False), (False, True), (False, False)]
# The fused backend's coefficients against the sdpa backend's (the same
# pipeline, plain attention), relative RMS: bf16 rounding in another order
# through 19 double blocks. On an H100 80GB HBM3 at 700 W: the output tap
# and cross-only 1.4e-4, self-only 1.3e-3, cross_attention 0.0125, value
# 0.0133, DAAMFlux (a softmax over the caption's words) 0.046; the control,
# the fused layers 0-3 in place of 14-17, 0.746.
EVAL_COEFF_LIMIT = 2.0**-4
# segment_batch at B=4 against per-image calls, relative RMS of the target
# coefficients (no softmax over concepts, unlike encode_images' heatmaps):
# 1.27e-4 to 1.33e-4 on an H100 80GB HBM3 at 700 W, bf16 GEMMs summing in
# another order; the limit is 7.3x the largest reading, the control (image 1
# with seed 5 in place of 4) read 0.0198, 20x the limit.
EVAL_BATCH_LIMIT = 2.0**-10
# pixAcc, mIoU and mAP of the harness at --image_batch 1 and 4, absolute: the
# labels are the masks segment_batch draws for the images, so the batch-4 run
# scores 1.0 and the batch-1 run loses only the tokens its bf16 rounding
# flips; the control is a model with another seed at batch 4.
EVAL_METRIC_LIMIT = 2.0**-5
# per_layer_coefficients against segment_individual_image at one layer, and
# the concept basis's product against the output map of the same forward,
# relative: the same launches on the same inputs, sums in another order.
EVAL_SAME_FORWARD_LIMIT = 2.0**-12


def eval_k1_runs():
    """{eval path: {(b, cross, self, c): stopped forwards}}: what each path
    of `eval_path` runs through K1 (19 launches a forward); the sdpa paths
    run none."""
    cs = (True, True)
    b1, b4 = (1, *cs, 6), (EVAL_BATCH, *cs, 6)
    voc = Counter((1, *cs, 5 + len(present)) for present in EVAL_VOC_PRESENT)
    return {
        "segment: output, cross_attention, value taps (fused)": {b1: 3},
        "segment: cross-only ablation (fused)": {(1, True, False, 6): 1},
        "segment: self-only ablation (fused)": {(1, False, True, 6): 1},
        "segment: the five cases and DAAMFlux (sdpa)": {},
        "per_layer_coefficients and 4 one-layer segment calls": {b1: 1 + len(EVAL_LAYERS)},
        f"segment_batch B={EVAL_BATCH}": {b4: 1},
        f"{EVAL_BATCH} per-image segment calls and the other-seed control": {b1: EVAL_BATCH + 1},
        "concept basis and the output map of its forward": {b1: 2},
        "harness labels: segment_batch of the images": {b4: EVAL_IMAGES // EVAL_BATCH},
        f"imagenet harness --image_batch {EVAL_BATCH}": {b4: EVAL_IMAGES // EVAL_BATCH},
        "imagenet harness --image_batch 1": {b1: EVAL_IMAGES},
        f"imagenet harness --image_batch {EVAL_BATCH}, other-seed control":
            {b4: EVAL_IMAGES // EVAL_BATCH},
        f"voc multi-class runner, {len(EVAL_VOC_PRESENT)} images": dict(voc),
        "DAAMFlux, 8-word caption (fused)": {(1, *cs, len(EVAL_DAAM_CAPTION.split())): 1},
    }


def eval_flash_phases(cfg):
    """K1 at the eval path's shapes: the double block at 512^2 with 6
    concepts at batch 1 and EVAL_BATCH in the four cross / self modes, and
    with 7 (VOC) and 8 (DAAMFlux) concepts at batch 1; main-path launches
    from `eval_k1_runs`."""
    from conceptattention_torch.kernels import flash_saliency as fs

    launches = Counter()
    for runs in eval_k1_runs().values():
        for key, forwards in runs.items():
            launches[key] += forwards * cfg.depth
    gen = torch.Generator("cuda").manual_seed(5)
    h, d = cfg.num_heads, cfg.head_dim
    results = []
    for b, c, modes in ((1, 6, CROSS_SELF_MODES), (EVAL_BATCH, 6, CROSS_SELF_MODES),
                        (1, 7, CROSS_SELF_MODES[:1]), (1, 8, CROSS_SELF_MODES[:1])):
        (q, k, v, t, p, c, _, _, cos, sin), qr, kr = joint_rows_inputs(
            cfg, gen, b, 256, size=EVAL_SIZE, c=c)
        s = t + p + c
        for cross, self_attention in modes:
            args = (q, k, v, t, p, c, cross, self_attention, cos, sin)
            mask = fs.segment_mask(s, t, p, c, cross, self_attention, "cuda")
            flipped = {
                "self_attention flipped": (*args[:7], not self_attention, cos, sin),
                "cross flipped": (*args[:6], not cross, self_attention, cos, sin),
            }
            controls = [(label, "concept rows",
                         lambda _, a=a: fs.fused_concept_flash_attention_plain(*a))
                        for label, a in flipped.items()]
            if cross and self_attention:
                controls.append(("one img key tile dropped", "joint rows",
                                 lambda want, a=args: drop_key_tile(want, a, t + 64 * 8)))
            results.append(phase_result(
                f"flash_saliency eval double_block B={b} S={s} C={c} cross={cross} "
                f"self={self_attention}",
                lambda a=args: fs.fused_concept_flash_attention(*a),
                lambda a=args: fs.fused_concept_flash_attention_plain(*a),
                lambda m=mask, qr=qr, kr=kr, v=v: F.scaled_dot_product_attention(
                    qr, kr, v, attn_mask=m),
                b * 4 * d * mask.sum().item() * h, b * (4 * h * s * d * 2 + 2 * s * d * 4),
                launches[(b, cross, self_attention, c)],
                {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)}, controls,
            ))
        del q, k, v, cos, sin, qr, kr
        torch.cuda.empty_cache()
    return results


def eval_breakdown(model, images, concepts):
    """Host seconds (median of 3, each ending in a synchronise) of the
    stages of a harness image: the VAE encode of one image, its caption and
    concepts through the pipeline's text encoders, the stopped forward at
    batch 1 and EVAL_BATCH on encoded latents, the whole per-image segment
    call, and scoring one image's mask and coefficients on the host."""
    from conceptattention_torch.experiments import imagenet_segmentation as harness
    from conceptattention_torch.pipeline.concept_pipeline import (
        _full_f32,
        batched_images_saliency,
        batched_noise_saliency,
    )
    from conceptattention_torch.utils.eval_state import SegEvalState

    pipe = model.pipe
    b = EVAL_BATCH
    (mask,), (coeff,), _ = model([images[0]], [EVAL_TARGET], concepts, [EVAL_TARGET])

    def seconds(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    with torch.inference_mode(), _full_f32():
        zs = pipe._encode_pixels_batch(images[:b], EVAL_SIZE, EVAL_SIZE, [model.seed] * b)
        t = model._noise_step(zs)
        txt, txt_ids, _ = pipe._prepare_text(EVAL_TARGET, b, need_clip=False)
        c_emb, c_ids, c_vec = pipe._prepare_concepts(concepts, b)
        spec = model._spec()
        return {
            "vae encode, one image": seconds(lambda: pipe._encode_pixels(
                images[0], EVAL_SIZE, EVAL_SIZE, model.seed)),
            "stopped forward B=1": seconds(lambda: batched_noise_saliency(
                pipe, zs[:1], t, 1, EVAL_SIZE, EVAL_SIZE, model.seed, txt[:1], txt_ids[:1],
                c_vec[:1], c_emb[:1], c_ids[:1], c_vec[:1], spec)),
            f"stopped forward B={b}": seconds(lambda: batched_images_saliency(
                pipe, zs, t, 1, EVAL_SIZE, EVAL_SIZE, model.seed, txt, txt_ids, c_vec, c_emb,
                c_ids, c_vec, spec)),
            "caption and concepts, one image": seconds(lambda: (
                pipe._prepare_text(EVAL_TARGET, 1, need_clip=False),
                pipe._prepare_concepts(concepts, 1))),
            "segment call, one image": seconds(lambda: model(
                [images[0]], [EVAL_TARGET], concepts, [EVAL_TARGET])),
            "scoring one image": seconds(lambda: harness.score_one(
                SegEvalState(), 0, 1, "timing", mask, mask, coeff)),
        }


def eval_path(pipe, counters):
    """The segmentation eval path on the flux-schnell pipeline at the
    harness protocol (EVAL_SIZE, 4 steps, noise step 2, EVAL_LAYERS): the
    Flux tap models on the fused backend against the same models on the
    sdpa backend (taps output, cross_attention, value; the cross-only and
    self-only ablations; DAAMFlux), `segment_batch` against per-image calls,
    `per_layer_coefficients` against one-layer calls, the concept basis
    against the output map, the ImageNet harness functions at --image_batch
    1 and EVAL_BATCH over EVAL_IMAGES images held in memory, and the VOC
    multi-class runner. Counters are [K1, K2, K1 hopper, K2 hopper]; each
    path's K1 launches must be what `eval_k1_runs` says. Returns ({path:
    (launches, seconds)}, the harness's in-memory dataset)."""
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.datasets import VOC_CLASSES
    from conceptattention_torch.evals.segmentation import (
        DAAMFluxSegmentationModel,
        FluxMultiClassSegmentationModel,
        FluxTapSegmentationModel,
    )
    from conceptattention_torch.experiments import imagenet_segmentation as harness
    from conceptattention_torch.experiments import voc_multi_class
    from conceptattention_torch.ops.attention import ConceptAttentionSpec
    from conceptattention_torch.ops.schedule import get_schedule
    from conceptattention_torch.pipeline.concept_encoding import (
        generate_concept_basis_and_image_representation,
    )
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32, batched_noise_saliency
    from conceptattention_torch.utils.eval_state import SegEvalState
    from conceptattention_torch.utils.plotting import upsample_nearest

    depth = pipe.cfg.depth
    expected = eval_k1_runs()
    paths = {}

    def run(label, fn):
        out, seconds, launches = counted(fn, counters)
        want = depth * sum(expected[label].values())
        if launches != [want, 0, want, 0]:
            raise AssertionError(f"eval path {label!r}: launches {launches}, want K1 {want}")
        paths[label] = (launches, seconds)
        return out

    plain_pipe = ConceptAttentionFluxPipeline(
        pipe.model_name, dtype=pipe.dtype, params=pipe.params, ae_params=pipe.ae_params,
        text_encoders=pipe.text_encoders, attention_backend="sdpa", device=pipe.device)
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (EVAL_SIZE, EVAL_SIZE, 3), dtype=np.uint8)
              for _ in range(EVAL_IMAGES)]
    concepts = harness.concepts_for(EVAL_TARGET, harness.BACKGROUND_CONCEPTS)
    kw = dict(num_steps=4, noise_timestep=2, layer_indices=EVAL_LAYERS, width=EVAL_SIZE,
              height=EVAL_SIZE)
    daam_concepts = [EVAL_TARGET, "grass"]

    def coeffs(model, image=images[0]):
        return model.segment_individual_image(image, concepts, EVAL_TARGET)[0]

    def daam(p):
        return DAAMFluxSegmentationModel(p, **kw).segment_individual_image(
            images[0], daam_concepts, EVAL_DAAM_CAPTION)[0]

    cases = {"output": dict(tap="output"), "cross_attention": dict(tap="cross_attention"),
             "value": dict(tap="value"),
             "cross-only": dict(tap="output", concept_self_attention=False),
             "self-only": dict(tap="output", concept_cross_attention=False)}
    fused = run("segment: output, cross_attention, value taps (fused)", lambda: {
        name: coeffs(FluxTapSegmentationModel(pipe, **kw, **cases[name]))
        for name in ("output", "cross_attention", "value")})
    fused["cross-only"] = run("segment: cross-only ablation (fused)", lambda: coeffs(
        FluxTapSegmentationModel(pipe, **kw, **cases["cross-only"])))
    fused["self-only"] = run("segment: self-only ablation (fused)", lambda: coeffs(
        FluxTapSegmentationModel(pipe, **kw, **cases["self-only"])))
    fused["DAAMFlux"] = run("DAAMFlux, 8-word caption (fused)", lambda: daam(pipe))
    plain = run("segment: the five cases and DAAMFlux (sdpa)", lambda: {
        **{name: coeffs(FluxTapSegmentationModel(plain_pipe, **kw, **case))
           for name, case in cases.items()}, "DAAMFlux": daam(plain_pipe)})
    per_layer, one_layer = run("per_layer_coefficients and 4 one-layer segment calls", lambda: (
        FluxTapSegmentationModel(pipe, **kw).per_layer_coefficients(images[0], concepts,
                                                                    EVAL_TARGET),
        [coeffs(FluxTapSegmentationModel(pipe, **dict(kw, layer_indices=[l])))
         for l in EVAL_LAYERS]))

    def mask_share(got, want):
        return float(np.mean((got[0] > got[0].mean()) == (want[0] > want[0].mean())))

    backends = {name: {"coeff_rel_rms": np_rel_rms(fused[name], plain[name]),
                       "target_mask_agreement": mask_share(fused[name], plain[name])}
                for name in fused}
    backend_control = np_rel_rms(per_layer[:4].mean(0), plain["output"])
    ok_backends = max(r["coeff_rel_rms"] for r in backends.values()) <= EVAL_COEFF_LIMIT \
        < backend_control
    print(f"eval: fused against sdpa at {EVAL_SIZE}^2 layers {EVAL_LAYERS}: "
          f"{json.dumps(backends)}; control (fused layers 0-3) {backend_control}, limit "
          f"{EVAL_COEFF_LIMIT}, ok={ok_backends}", flush=True)

    layer_errs = [np_rel_rms(per_layer[l], c) for l, c in zip(EVAL_LAYERS, one_layer)]
    layer_mean = np_rel_rms(per_layer[EVAL_LAYERS].mean(0), fused["output"])
    layer_control = np_rel_rms(per_layer[EVAL_LAYERS[0] - 1], one_layer[0])
    ok_layers = max(layer_errs + [layer_mean]) <= EVAL_SAME_FORWARD_LIMIT < layer_control
    print(f"eval: per_layer_coefficients against one-layer segment calls, relative RMS per "
          f"layer {layer_errs}, layers {EVAL_LAYERS} averaged {layer_mean}; control (the layer "
          f"before) {layer_control}, limit {EVAL_SAME_FORWARD_LIMIT}, ok={ok_layers}", flush=True)

    targets, lists = [EVAL_TARGET] * EVAL_BATCH, [concepts] * EVAL_BATCH
    batch = run(f"segment_batch B={EVAL_BATCH}", lambda: FluxTapSegmentationModel(
        pipe, **kw).segment_batch(images[:EVAL_BATCH], targets, lists, targets))

    def single_calls():
        model = FluxTapSegmentationModel(pipe, **kw)
        other_seed = FluxTapSegmentationModel(pipe, **kw, seed=5)
        return ([model([im], [EVAL_TARGET], concepts, [EVAL_TARGET]) for im in
                 images[:EVAL_BATCH]], other_seed([images[1]], [EVAL_TARGET], concepts,
                                                  [EVAL_TARGET]))

    single, other_seed = run(
        f"{EVAL_BATCH} per-image segment calls and the other-seed control", single_calls)
    batch_errs = [np_rel_rms(batch[1][i], single[i][1][0]) for i in range(EVAL_BATCH)]
    batch_masks = [float(np.mean(batch[0][i] == single[i][0][0])) for i in range(EVAL_BATCH)]
    batch_control = np_rel_rms(batch[1][1], other_seed[1][0])
    ok_batch = max(batch_errs) <= EVAL_BATCH_LIMIT < batch_control
    print(f"eval: segment_batch B={EVAL_BATCH} against per-image calls: coefficients relative "
          f"RMS {batch_errs}, target mask agreement {batch_masks}; control (image 1 with seed "
          f"5) {batch_control}, limit {EVAL_BATCH_LIMIT}, ok={ok_batch}", flush=True)

    basis_layers, seed = EVAL_LAYERS[1:3], 63

    @torch.inference_mode()
    @_full_f32()
    def output_map():
        """The output map of the basis's forward: its inputs, the map spec."""
        z = pipe._encode_pixels(images[0], EVAL_SIZE, EVAL_SIZE, seed)
        t = get_schedule(4, (z.shape[2] // 2) * (z.shape[3] // 2), shift=not pipe.is_schnell)[2]
        txt, txt_ids, vec = pipe._prepare_text(EVAL_TARGET, 1)
        c_emb, c_ids, c_vec = pipe._prepare_concepts(concepts, 1)
        return batched_noise_saliency(
            pipe, z, t, 1, EVAL_SIZE, EVAL_SIZE, seed, txt, txt_ids, vec, c_emb, c_ids, c_vec,
            ConceptAttentionSpec(taps=("output",)))["output"][0, :, 0].float().cpu().numpy()

    (iv, cv), maps = run("concept basis and the output map of its forward", lambda: (
        generate_concept_basis_and_image_representation(
            pipe, images[0], EVAL_TARGET, concepts, layers=basis_layers,
            normalize_concepts=False, reduce_dims=False, height=EVAL_SIZE, width=EVAL_SIZE,
            seed=seed), output_map()))
    if iv.shape != (2, 1, (EVAL_SIZE // (2 * pipe.vae_factor)) ** 2, pipe.cfg.hidden_size) or \
            cv.shape != (2, 1, len(concepts), pipe.cfg.hidden_size):
        raise AssertionError(f"concept basis shapes {iv.shape} {cv.shape}")

    def rel_max(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    layer = basis_layers[1]
    basis_err = rel_max((iv[1, 0] @ cv[1, 0].T).T, maps[layer])
    basis_control = rel_max((iv[0, 0] @ cv[0, 0].T).T, maps[layer])
    ok_basis = basis_err <= EVAL_SAME_FORWARD_LIMIT < basis_control
    print(f"eval: concept basis image_vectors @ concept_vectors.T at layer {layer} against the "
          f"output map: relative max error {basis_err}; control (layer {basis_layers[0]}'s "
          f"vectors) {basis_control}, limit {EVAL_SAME_FORWARD_LIMIT}, ok={ok_basis}", flush=True)
    del iv, cv, maps

    model = FluxTapSegmentationModel(pipe, **kw)

    def label_masks():
        return [m for lo in range(0, EVAL_IMAGES, EVAL_BATCH) for m in model.segment_batch(
            images[lo:lo + EVAL_BATCH], targets, lists, targets)[0]]

    labels = run("harness labels: segment_batch of the images", label_masks)
    dataset = [(im, (upsample_nearest(m.astype(np.float64), EVAL_SIZE, EVAL_SIZE) > 0.5)
                .astype(np.int64), f"{EVAL_TARGET}_{i}")
               for i, (im, m) in enumerate(zip(images, labels))]
    states = {}
    for b, m, label in ((EVAL_BATCH, model, f"imagenet harness --image_batch {EVAL_BATCH}"),
                        (1, model, "imagenet harness --image_batch 1"),
                        (EVAL_BATCH, FluxTapSegmentationModel(pipe, **kw, seed=5),
                         f"imagenet harness --image_batch {EVAL_BATCH}, other-seed control")):
        states[label] = run(label, lambda b=b, m=m: harness.run(
            m, dataset, SegEvalState(), EVAL_IMAGES, image_batch=b))
    st4, st1, control = states.values()
    metrics = {key: (getattr(st4, key), getattr(st1, key), getattr(control, key))
               for key in ("pix_acc", "miou", "mean_ap")}
    metric_err = max(abs(a - b) for a, b, _ in metrics.values())
    metric_control = max(abs(a - c) for a, _, c in metrics.values())
    ok_harness = metric_err <= EVAL_METRIC_LIMIT < metric_control
    seconds = {label: paths[label][1] / EVAL_IMAGES for label in states}
    print(f"eval: imagenet harness over {EVAL_IMAGES} images at {EVAL_SIZE}^2, metrics [batch "
          f"{EVAL_BATCH}, batch 1, control]: {json.dumps(metrics)}; largest difference "
          f"{metric_err}, control {metric_control}, limit {EVAL_METRIC_LIMIT}, ok={ok_harness}; "
          f"seconds per image {json.dumps(seconds)}; K1 launches per image {depth}", flush=True)

    print(f"eval: where a harness image's time goes (warm seconds, median of 3): "
          f"{json.dumps(eval_breakdown(model, images, concepts))}", flush=True)

    voc_model = FluxMultiClassSegmentationModel(
        pipe, num_steps=4, noise_timestep=2, layer_indices=list(range(14, 19)),
        width=EVAL_SIZE, height=EVAL_SIZE)
    voc = []
    for i, present in enumerate(EVAL_VOC_PRESENT):
        mask = np.zeros((EVAL_SIZE, EVAL_SIZE), np.uint8)
        for j, name in enumerate(present):
            mask[(j + 1) * 100:(j + 2) * 100] = VOC_CLASSES.index(name) + 1
        mask[:, :4] = 255
        voc.append((images[i], mask, present))
    label = f"voc multi-class runner, {len(EVAL_VOC_PRESENT)} images"
    miou, pix_acc = run(label, lambda: voc_multi_class.run(
        voc_model, voc, [f"voc_{i}" for i in range(len(voc))], len(voc)))
    ok_voc = 0.0 <= miou <= 1.0 and 0.0 <= pix_acc <= 1.0
    print(f"eval: voc multi-class runner: mIoU {miou}, pixAcc {pix_acc}, seconds "
          f"{paths[label][1]}", flush=True)
    print(f"eval paths (launches [K1, K2, K1 hopper, K2 hopper], seconds): "
          f"{json.dumps(paths)}", flush=True)
    del plain_pipe
    gc.collect()
    torch.cuda.empty_cache()
    if not (ok_backends and ok_layers and ok_batch and ok_basis and ok_harness and ok_voc):
        raise AssertionError("eval path: a reading or its control is on the wrong side of its "
                             "limit")
    return paths, dataset


# The sweeps over the eval path: the per-layer sweep on flux-schnell (256 txt
# rows) and the per-timestep sweep on flux-dev (512 txt rows) at 512^2, with
# their four concepts [target, "background", "floor", "sky"] (C = 4).
SWEEP_LAYERS = EVAL_LAYERS
SWEEP_TIME_STEPS = 50
SWEEP_TIMESTEPS = [0, 25, 45]
SWEEP_TIME_IMAGES = 2
# A sweep row against the same images' scores through one-layer models:
# the same launches on the same inputs (per-layer coefficients read bit for
# bit equal to one-layer calls on an H100 80GB HBM3 at 700 W), so the limit
# is exact equality up to float rounding of the ratios.
SWEEP_ROW_LIMIT = 1e-12
SWEEP_SIGMA_LIMIT = 1e-9


def sweep_k1_runs():
    """{(t, c): stopped forwards} of the sweeps' K1 runs (19 launches a
    forward): the per-layer sweep over the harness images and its one-layer
    checks, and the per-timestep sweep."""
    return {(256, 4): EVAL_IMAGES * (1 + len(SWEEP_LAYERS)),
            (512, 4): SWEEP_TIME_IMAGES * len(SWEEP_TIMESTEPS)}


def sweep_flash_phases(cfg):
    """K1 at the sweeps' double block: 512^2 with 4 concepts at B=1, with
    256 txt rows (flux-schnell, S=1284) and 512 (flux-dev, S=1540)."""
    from conceptattention_torch.kernels import flash_saliency as fs

    gen = torch.Generator("cuda").manual_seed(6)
    h, d = cfg.num_heads, cfg.head_dim
    results = []
    for (t_rows, c), forwards in sweep_k1_runs().items():
        args, qr, kr = joint_rows_inputs(cfg, gen, 1, t_rows, size=EVAL_SIZE, c=c)
        q, k, v, t, p, c, cross, self_attention, cos, sin = args
        s = t + p + c
        mask = fs.segment_mask(s, t, p, c, cross, self_attention, "cuda")
        flipped = (*args[:7], not self_attention, cos, sin)
        results.append(phase_result(
            f"flash_saliency sweep double_block B=1 S={s} ({t} txt rows) C={c}",
            lambda a=args: fs.fused_concept_flash_attention(*a),
            lambda a=args: fs.fused_concept_flash_attention_plain(*a),
            lambda m=mask, qr=qr, kr=kr, v=v: F.scaled_dot_product_attention(
                qr, kr, v, attn_mask=m),
            4 * d * mask.sum().item() * h, 4 * h * s * d * 2 + 2 * s * d * 4,
            forwards * cfg.depth,
            {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)},
            [("self_attention flipped", "concept rows",
              lambda _, a=flipped: fs.fused_concept_flash_attention_plain(*a)),
             ("one img key tile dropped", "joint rows",
              lambda want, a=args: drop_key_tile(want, a, t + 64 * 8))],
        ))
        del q, k, v, cos, sin, qr, kr
        torch.cuda.empty_cache()
    return results


def per_layer_sweep(pipe, counters, dataset):
    """The per-layer sweep (`experiments.per_layer_segmentation.run`) over
    the harness's in-memory images on the flux-schnell pipeline at 512^2,
    4 steps, noise step 2; its rows for SWEEP_LAYERS held against the scores
    of one-layer models over the same images, the control a row against
    the next layer's one-layer scores. Counters are [K1, K2, K1 hopper, K2
    hopper]. Returns (launches, seconds) of the sweep and its checks."""
    from conceptattention_torch.evals.segmentation import FluxTapSegmentationModel
    from conceptattention_torch.experiments import per_layer_segmentation as sweep

    depth = pipe.cfg.depth
    kw = dict(num_steps=4, noise_timestep=2, width=EVAL_SIZE, height=EVAL_SIZE)
    n = len(dataset)
    rows, seconds, launches = counted(lambda: sweep.run(
        FluxTapSegmentationModel(pipe, **kw), dataset, n), counters)
    if launches != [n * depth, 0, n * depth, 0]:
        raise AssertionError(f"per_layer sweep: launches {launches}, want K1 {n * depth}")

    def one_layer_scores():
        scores = {}
        for layer in SWEEP_LAYERS:
            model = FluxTapSegmentationModel(pipe, layer_indices=[layer], **kw)
            stats = sweep.new_stats()
            for image, gt_mask, name in dataset:
                target = sweep.target_of(name)
                (mask,), _, _ = model([image], [target], [target, *sweep.SWEEP_BACKGROUND],
                                      [target])
                sweep.score_mask(stats, mask, sweep.label_of(gt_mask, 224))
            scores[layer] = sweep.metrics(stats)
        return scores

    scores, check_seconds, check_launches = counted(one_layer_scores, counters)
    want = n * len(SWEEP_LAYERS) * depth
    if check_launches != [want, 0, want, 0]:
        raise AssertionError(f"per_layer sweep checks: launches {check_launches}, want K1 {want}")
    errs = {layer: max(abs(a - b) for a, b in zip(rows[layer][1:], scores[layer]))
            for layer in SWEEP_LAYERS}
    control = max(abs(a - b) for a, b in zip(rows[SWEEP_LAYERS[0]][1:],
                                             scores[SWEEP_LAYERS[1]]))
    ok = max(errs.values()) <= SWEEP_ROW_LIMIT < control
    if len(rows) != depth or not all(0.0 <= x <= 1.0 for r in rows for x in r[1:]):
        raise AssertionError(f"per_layer sweep rows {rows}")
    print(f"per_layer sweep over {n} images at {EVAL_SIZE}^2 (S=1284): rows [layer, pix_acc, "
          f"miou] {json.dumps(rows)}; seconds per image {seconds / n}; K1 launches per image "
          f"{depth}; rows {SWEEP_LAYERS} against one-layer models' scores: largest difference "
          f"{json.dumps(errs)}, control (layer {SWEEP_LAYERS[0]}'s row against layer "
          f"{SWEEP_LAYERS[1]}'s scores) {control}, limit {SWEEP_ROW_LIMIT}, ok={ok}; one-layer "
          f"checks {check_seconds} s", flush=True)
    if not ok:
        raise AssertionError("per_layer sweep: a row or its control is on the wrong side of "
                             "its limit")
    return [a + b for a, b in zip(launches, check_launches)], seconds + check_seconds


def shifted_sigma(num_steps: int, step: int, image_seq_len: int) -> float:
    """Flux's shifted schedule at `step`, written out: t = 1 - step /
    num_steps, mu linear in the image's tokens from 0.5 at 256 to 1.15 at
    4096, sigma = e^mu / (e^mu + 1/t - 1)."""
    t = 1.0 - step / num_steps
    mu = 0.5 + (1.15 - 0.5) * (image_seq_len - 256) / (4096 - 256)
    return math.exp(mu) / (math.exp(mu) + 1.0 / t - 1.0)


def per_timestep_sweep(pipe, counters, dataset):
    """The per-timestep sweep (`experiments.per_timestep_segmentation`) on
    the flux-dev pipeline at 512^2, SWEEP_TIME_STEPS steps, SWEEP_TIMESTEPS,
    layers 14-17, over `dataset`: each model's sigma against the shifted
    schedule written out for a 512^2 image (1024 image tokens), the control
    the sigma of a 1024^2 image (4096). Counters are [K1, K2, K1 hopper, K2
    hopper]. Returns (launches, seconds)."""
    from conceptattention_torch.experiments import per_timestep_segmentation as sweep

    models = sweep.models_per_timestep(pipe, SWEEP_TIMESTEPS, num_steps=SWEEP_TIME_STEPS,
                                       layers=SWEEP_LAYERS, width=EVAL_SIZE)
    latent = torch.empty(1, 16, EVAL_SIZE // pipe.vae_factor, EVAL_SIZE // pipe.vae_factor)
    sigmas = {t: (m._noise_step(latent), shifted_sigma(SWEEP_TIME_STEPS, t, 1024),
                  shifted_sigma(SWEEP_TIME_STEPS, t, 4096)) for t, m in models.items()}
    sigma_err = max(abs(used - want) for used, want, _ in sigmas.values())
    sigma_control = max(abs(used - other) for used, _, other in sigmas.values())
    ok = sigma_err <= SWEEP_SIGMA_LIMIT < sigma_control
    n = len(dataset)
    rows, seconds, launches = counted(lambda: sweep.run(models, dataset, n), counters)
    want = n * len(SWEEP_TIMESTEPS) * pipe.cfg.depth
    if launches != [want, 0, want, 0]:
        raise AssertionError(f"per_timestep sweep: launches {launches}, want K1 {want}")
    if [r[0] for r in rows] != SWEEP_TIMESTEPS or not all(
            0.0 <= x <= 1.0 for r in rows for x in r[1:]):
        raise AssertionError(f"per_timestep sweep rows {rows}")
    print(f"per_timestep sweep (flux-dev, {SWEEP_TIME_STEPS} steps) over {n} images at "
          f"{EVAL_SIZE}^2 (S=1540): rows [timestep, pix_acc, miou] {json.dumps(rows)}; sigma "
          f"[used, the schedule at 1024 image tokens, at 4096] per timestep "
          f"{json.dumps(sigmas)}; largest difference {sigma_err}, control (the 1024^2 "
          f"schedule) {sigma_control}, limit {SWEEP_SIGMA_LIMIT}, ok={ok}; seconds per image and "
          f"timestep {seconds / (n * len(SWEEP_TIMESTEPS))}; K1 launches per image and timestep "
          f"{pipe.cfg.depth}", flush=True)
    if not ok:
        raise AssertionError("per_timestep sweep: the sigma or its control is on the wrong side "
                             "of its limit")
    return launches, seconds


# The ViT family on the card in f32 (TF32 off) against the same port code on
# the CPU, relative RMS of the saliency maps: f32 sums in another order (5e-7
# to 6e-6 on an H100 80GB HBM3 at 700 W). The relevance methods are held in
# f64 instead: their rules divide by activations and sums near zero, which
# amplify a relative change of the input about 1e5-fold at ViT-B's depth
# (f64 on the CPU: 1e-14 in, 1.4e-9 out for the pixel LRP), so their f32
# maps differ by 1e-3 to 1 between two orders of summation. Their f32
# readings are printed beside, not held.
VIT_LIMIT = 2.0**-10
VIT_F64_LIMIT = 2.0**-20
VIT_RELEVANCE = ("CheferLRP", "CheferTransformerAttribution", "CheferFullLRP",
                 "CheferLastLayerLRP")
VIT_CHEFER = ["CheferLRP", "CheferRollout", "CheferLastLayerAttention", "CheferAttentionGradCAM",
              "CheferTransformerAttribution", "CheferFullLRP", "CheferLastLayerLRP", "DINO"]
VIT_CONCEPTS = ["dog", "sky"]
VIT_HARNESS = ["CheferLRP", "CheferAttentionGradCAM", "DINO", "TextSpan"]


def to_cpu(tree):
    from conceptattention_torch.models.flux.params import tree_map

    return tree_map(lambda x: x.cpu(), tree)


def card_seconds(fn):
    """(result, host seconds) of `fn` from an idle card to its end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def vit_family_path(dataset, counters):
    """The ViT family at full width with random weights: the 8 ViT-B/16
    baselines (224^2, 12 layers of 768, 1000 classes; the zoo's seed 0),
    `CLIPTextSpanSegmentationModel` over that ViT-B with the stand-in text
    encoders, and the open_clip ViT-H/14 TextSpan model (1280 wide, 32
    layers; text 1024 wide, 24 layers, 77 tokens): each one image's map on
    the card held against the same code on the CPU, the control the CPU map
    of another method (ViT-B) or of another seed's ViT-H (seed 1). The
    relevance methods (VIT_RELEVANCE) are held in f64, their f32 maps read
    beside (card against CPU, and each against its own f64 map). The ViT-H
    TextSpan map on the CPU scores against the card's concept
    vectors (80 templates a concept through a 24-layer tower is minutes
    there); its text tower is held on 4 templates apart. Then the ImageNet
    harness (`build_model` with --random_weights, `run`) for VIT_HARNESS
    over `dataset`. No kernel of the port runs on this path: every counter
    must stay 0."""
    from conceptattention_torch.evals import model_zoo
    from conceptattention_torch.evals.baselines import ViTAttentionSegmentationModel, _preprocess
    from conceptattention_torch.evals.lrp import _attn_gradients
    from conceptattention_torch.evals.textspan import (
        PROMPT_TEMPLATES,
        CLIPTextSpanSegmentationModel,
        OpenCLIPTextSpanSegmentationModel,
    )
    from conceptattention_torch.experiments import imagenet_segmentation as harness
    from conceptattention_torch.models import clip_vit
    from conceptattention_torch.models.flux.params import tree_map
    from conceptattention_torch.models.text.encoders import StubTextEncoders
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32
    from conceptattention_torch.utils.eval_state import SegEvalState

    torch.set_num_threads(8)
    image = dataset[0][0]
    readings, seconds, maps = {}, {}, {}

    def run():
        vit_cpu = None
        for name in VIT_CHEFER:
            model = model_zoo.build_segmentation_model(name, random_weights=True)
            model.segment_individual_image(image, VIT_CONCEPTS, "a dog")  # warm
            (card, _), seconds[name] = card_seconds(
                lambda: model.segment_individual_image(image, VIT_CONCEPTS, "a dog"))
            vit_cpu = vit_cpu or to_cpu(model.params)
            cpu, _ = ViTAttentionSegmentationModel(vit_cpu, model.cfg, model.method) \
                .segment_individual_image(image, VIT_CONCEPTS, "a dog")
            maps[name] = (card, cpu)
            if name in VIT_RELEVANCE:
                x = _preprocess(image, model.cfg.image_size).double()
                card64, cpu64 = (ViTAttentionSegmentationModel(
                    tree_map(lambda t: t.double(), p), model.cfg, model.method).saliency(
                        x.to(p["cls_token"].device)).cpu().numpy()
                    for p in (model.params, vit_cpu))
                readings[f"{name}, f32 (not held)"] = {
                    "card against cpu": np_rel_rms(card[0], cpu[0]),
                    "card against card f64": np_rel_rms(card[0], card64[0]),
                    "cpu against cpu f64": np_rel_rms(cpu[0], cpu64[0])}
                maps[name] = (card64, cpu64)
            if name == "CheferAttentionGradCAM":
                size = model.cfg.image_size
                x = torch.from_numpy(np.random.default_rng(3).standard_normal(
                    (1, 3, size, size)).astype(np.float32))
                idx = torch.tensor([3])
                with _full_f32():
                    g_card = _attn_gradients(model.params, model.cfg, x.cuda(), idx.cuda())[-1]
                g_cpu = _attn_gradients(vit_cpu, model.cfg, x, idx)[-1]
                readings["GradCAM last-layer dlogit/dA"] = {"rel_rms": np_rel_rms(
                    g_card.cpu(), g_cpu)}
        enc = StubTextEncoders(clip_dim=768)
        card_ts = CLIPTextSpanSegmentationModel(model.params, model.cfg, enc)
        card_ts.segment_individual_image(image, VIT_CONCEPTS, "a dog")
        (card, _), seconds["CLIPTextSpan (ViT-B)"] = card_seconds(
            lambda: card_ts.segment_individual_image(image, VIT_CONCEPTS, "a dog"))
        cpu, _ = CLIPTextSpanSegmentationModel(vit_cpu, model.cfg, enc).segment_individual_image(
            image, VIT_CONCEPTS, "a dog")
        maps["CLIPTextSpan (ViT-B)"] = (card, cpu)
        del model, card_ts, vit_cpu

        model = model_zoo.build_segmentation_model("TextSpan", random_weights=True)
        model.segment_individual_image(image, VIT_CONCEPTS, "a dog")  # warm, caches the vectors
        (card, _), seconds["TextSpan (ViT-H/14)"] = card_seconds(
            lambda: model.segment_individual_image(image, VIT_CONCEPTS, "a dog"))
        cpu_model = OpenCLIPTextSpanSegmentationModel(
            {"visual": to_cpu(model.params["visual"])}, model.vis_cfg, model.txt_cfg)
        cpu_model._concept_cache = dict(model._concept_cache)
        cpu, _ = cpu_model.segment_individual_image(image, VIT_CONCEPTS, "a dog")
        other = clip_vit.init_open_clip_params(torch.Generator(model.device).manual_seed(1),
                                               model.vis_cfg)
        cpu_model.params = to_cpu(other)
        del other
        control, _ = cpu_model.segment_individual_image(image, VIT_CONCEPTS, "a dog")
        maps["TextSpan (ViT-H/14)"] = (card, cpu, control)
        ids = model.tokenize([t.format(VIT_CONCEPTS[0]) for t in PROMPT_TEMPLATES[:4]])
        ids = torch.as_tensor(ids, dtype=torch.long)
        with torch.inference_mode(), _full_f32():
            t_card = clip_vit.text_encode(model.params["text"], model.txt_cfg, ids.cuda()).cpu()
        t_cpu = clip_vit.text_encode(to_cpu(model.params["text"]), model.txt_cfg, ids)
        readings["TextSpan (ViT-H/14) text tower, 4 templates"] = {
            "rel_rms": np_rel_rms(t_card, t_cpu)}
        del model, cpu_model

    _, total, launches = counted(run, counters)
    if any(launches):
        raise AssertionError(f"ViT family: kernel launches {launches}, want none")
    names = list(maps)
    for i, name in enumerate(names):
        card, cpu, *control = maps[name]
        if not control:  # another method's CPU map (the ViT-B family)
            others = [n for n in names[i + 1:] + names[:i] if maps[n][1].shape == cpu.shape
                      and not np.array_equal(maps[n][1], cpu)]
            control = [maps[others[0]][1]]
        limit = VIT_F64_LIMIT if name in VIT_RELEVANCE else VIT_LIMIT
        readings[name] = {"rel_rms": np_rel_rms(card, cpu), "dtype": str(cpu.dtype),
                          "limit": limit, "control_rel_rms": np_rel_rms(control[0], cpu),
                          "card_seconds": seconds[name],
                          "largest_cpu_value": float(np.abs(cpu).max())}
    ok = all(r["rel_rms"] <= r.get("limit", VIT_LIMIT) for r in readings.values()
             if "rel_rms" in r) and all(
        r["control_rel_rms"] > r["limit"] for r in readings.values() if "control_rel_rms" in r)
    print(f"ViT family, card (TF32 off) against the CPU, one {EVAL_SIZE}^2 image resized to "
          f"224^2, concepts {VIT_CONCEPTS}, relative RMS (f32; {VIT_RELEVANCE} in f64, their f32 "
          f"readings beside): {json.dumps(readings)}; ok={ok}; path seconds {total}", flush=True)

    def harness_runs():
        out = {}
        for name in VIT_HARNESS:
            args = harness.parse_args(["--mat_path", "in-memory", "--segmentation_model", name,
                                       "--random_weights"])
            harness.check_segmentation_model(args.segmentation_model, args.image_batch)
            model = harness.build_model(args)
            st, secs = card_seconds(lambda: harness.run(model, dataset, SegEvalState(),
                                                        len(dataset)))
            out[name] = {"seconds_per_image": secs / len(dataset), "final": st.summary()}
            print(f"ViT family harness --segmentation_model {name} --random_weights over "
                  f"{len(dataset)} images: FINAL {st.summary()}, seconds per image "
                  f"{secs / len(dataset)} (model build excluded)", flush=True)
            del model
        return out

    runs, _, launches = counted(harness_runs, counters)
    if any(launches):
        raise AssertionError(f"ViT family harness: kernel launches {launches}, want none")
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("ViT family: a reading or its control is on the wrong side of its "
                             "limit")
    return readings, runs


# The SD UNets: SD2-base and SDXL-base at the zoo's latent 32 and at
# latent 64 (the reference's 512^2), f32, TF32 off, random weights from seed
# 0; the card's eps and every cross-attention map against the CPU's f32 run,
# relative RMS (the largest over the maps). The controls run the CPU's
# forward with one planted fault at latent 32: one cross-attention's softmax
# scale off (the first mid-block attn2's q weight doubled, so its logits
# are), and one up-block resnet's time embedding dropped (its time_emb
# projection zeroed). On an H100 80GB HBM3 at 700 W the card read 6.3e-6 to
# 1.9e-5 from the CPU, the controls 0.0084 (SD2's dropped time embedding) to
# 1.35: the limit sits between.
UNET_LATENTS = (32, 64)
UNET_LIMIT = 2.0**-10
UNET_CTX_TOKENS = 77
UNET_TIMESTEP = 981.0
UNET_PARAMS = {"SD2-base": 865_910_724, "SDXL-base": 2_567_463_684}
DAAM_MODELS = ("DAAMSD2", "DAAMSDXL")


def with_leaf(tree, path, fn):
    """A copy of `tree` sharing every leaf but the one at `path`, which is
    fn(leaf)."""
    if not path:
        return fn(tree)
    head, *rest = path
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[head] = with_leaf(tree[head], rest, fn)
    return out


def unet_inputs(cfg, latent: int, device):
    """Seeded inputs at `latent`: (latents, timesteps, context, added
    conditions: SDXL's pooled text and time ids for an 8 * latent image)."""
    rng = np.random.default_rng(latent)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    args = (t(rng.standard_normal((1, cfg.in_channels, latent, latent))), t([UNET_TIMESTEP]),
            t(rng.standard_normal((1, UNET_CTX_TOKENS, cfg.context_dim))))
    added = {}
    if cfg.addition_embed_type == "text_time":
        side = 8 * latent
        added = {"text_embeds": t(rng.standard_normal((1, cfg.pooled_text_dim))),
                 "time_ids": t([[side, side, 0, 0, side, side]])}
    return args, added


def unet_run(params, cfg, latent, device):
    from conceptattention_torch.models.sd_unet import unet_forward
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    args, added = unet_inputs(cfg, latent, device)
    with torch.inference_mode(), _full_f32():
        eps, maps = unet_forward(params, cfg, *args, **added)
    return eps.cpu().numpy(), [m.cpu().numpy() for m in maps]


def unet_readings(got, want):
    (eps, maps), (eps_ref, maps_ref) = got, want
    if len(maps) != len(maps_ref) or any(a.shape != b.shape for a, b in zip(maps, maps_ref)):
        raise AssertionError("UNet maps differ in number or shape")
    return {"eps": np_rel_rms(eps, eps_ref),
            "maps": max(np_rel_rms(a, b) for a, b in zip(maps, maps_ref))}


def sd_unet_path(dataset, counters):
    """The SD2-base and SDXL-base UNets at full width on the card against
    the CPU, with their controls, the forward's seconds and device peak at
    each latent; then DAAMSD2 and DAAMSDXL through the ImageNet harness
    functions over `dataset`. No kernel of the port runs here."""
    from conceptattention_torch.experiments import imagenet_segmentation as harness
    from conceptattention_torch.models.flux.params import tree_leaves
    from conceptattention_torch.models.sd_unet import SDXL_BASE_CONFIG, UNetConfig, init_unet_params
    from conceptattention_torch.utils.eval_state import SegEvalState

    torch.set_num_threads(8)
    readings, ok = {}, True

    def run():
        nonlocal ok
        for name, cfg in (("SD2-base", UNetConfig()), ("SDXL-base", SDXL_BASE_CONFIG)):
            gc.collect()
            torch.cuda.empty_cache()
            params, build = card_seconds(
                lambda: init_unet_params(torch.Generator("cuda").manual_seed(0), cfg))
            n = sum(x.numel() for x in tree_leaves(params))
            if n != UNET_PARAMS[name]:
                raise AssertionError(f"{name}: {n} parameters, want {UNET_PARAMS[name]}")
            cpu = to_cpu(params)
            r = {"parameters": n, "build_seconds": build,
                 "parameters_gib": 4 * n / 2**30}
            for latent in UNET_LATENTS:
                unet_run(params, cfg, latent, "cuda")  # warm
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                card, secs = card_seconds(lambda: unet_run(params, cfg, latent, "cuda"))
                peak = (torch.cuda.max_memory_allocated() - before) / 2**30
                ref, cpu_secs = card_seconds(lambda: unet_run(cpu, cfg, latent, "cpu"))
                if not all(np.isfinite(a).all() for a in [card[0], *card[1]]):
                    raise AssertionError(f"{name} latent {latent}: non-finite output")
                held = unet_readings(card, ref)
                r[f"latent {latent}"] = {**held, "maps_count": len(card[1]),
                                         "forward_seconds": secs,
                                         "forward_peak_above_params_gib": peak,
                                         "cpu_seconds": cpu_secs}
                ok = ok and max(held.values()) <= UNET_LIMIT
            mid_q = ["mid", "attn", "blocks", 0, "attn2", "q", "w"]
            up_temb = ["up", 0, "resnets", 0, "time_emb"]
            latent = UNET_LATENTS[0]
            controls = {
                "cross-attention softmax scale off": with_leaf(cpu, mid_q, lambda w: 2 * w),
                "time embedding dropped in one resnet": with_leaf(
                    cpu, up_temb, lambda p: {k: torch.zeros_like(v) for k, v in p.items()}),
            }
            card = unet_run(params, cfg, latent, "cuda")
            for label, faulty in controls.items():
                held = unet_readings(unet_run(faulty, cfg, latent, "cpu"), card)
                key = "maps" if "softmax" in label else "eps"
                r[f"control: {label}"] = {key: held[key]}
                ok = ok and held[key] > UNET_LIMIT
            readings[name] = r
            del params, cpu, controls, card

    _, total, launches = counted(run, counters)
    if any(launches):
        raise AssertionError(f"SD UNets: kernel launches {launches}, want none")
    print(f"SD UNets, card (f32, TF32 off) against the CPU's f32 run, relative RMS (maps: the "
          f"largest over the cross-attention maps), limit {UNET_LIMIT}, controls at latent "
          f"{UNET_LATENTS[0]}, timestep {UNET_TIMESTEP}, {UNET_CTX_TOKENS} context tokens: "
          f"{json.dumps(readings)}; ok={ok}; path seconds {total}", flush=True)
    if not ok:
        raise AssertionError("SD UNets: a reading or its control is on the wrong side of its "
                             "limit")

    def harness_runs():
        out = {}
        for name in DAAM_MODELS:
            args = harness.parse_args(["--mat_path", "in-memory", "--segmentation_model", name,
                                       "--random_weights"])
            harness.check_segmentation_model(args.segmentation_model, args.image_batch)
            model, build = card_seconds(lambda: harness.build_model(args))
            st, secs = card_seconds(lambda: harness.run(model, dataset, SegEvalState(),
                                                        len(dataset)))
            final = st.summary()
            out[name] = {"seconds_per_image": secs / len(dataset), "final": final,
                         "build_seconds": build}
            print(f"DAAM harness --segmentation_model {name} --random_weights over "
                  f"{len(dataset)} images: FINAL {final}, seconds per image "
                  f"{secs / len(dataset)} (model build {build} s excluded)", flush=True)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        return out

    runs, _, launches = counted(harness_runs, counters)
    if any(launches):
        raise AssertionError(f"DAAM harness: kernel launches {launches}, want none")
    return readings, runs


# The perturbation test: ViT-B/16 at 224^2 (1000 classes, the zoo's
# seed 0), the harness's 8 images as one batch, labels the unmasked
# predictions, the 7 Chefer methods, positive and negative, 9 steps. The
# card's accuracies must equal the CPU's; the relevance methods' relevance is
# taken in f64 on both (their f32 maps are dominated by amplified
# rounding), the classification in f32. The mean drops of the target's
# probability are held too, absolute: 1.4e-8 apart on an H100 80GB HBM3 at
# 700 W, where random weights leave most accuracies at 0 after the first
# step. The control ranks ties the other way (ascending pixel index first)
# on the card: its accuracies must differ, and its drops break the limit.
PERT_F64 = ("transformer_attribution", "last_layer_lrp", "lrp", "full_lrp")
PERT_DROP_LIMIT = 2.0**-17


def perturbation_sweep(params, params64, cfg, x, labels):
    """{(method, negative): PerturbationResult} of the 7 methods on one
    batch, relevance in f64 for PERT_F64, classification in f32."""
    from conceptattention_torch.evals import perturbation as pert
    from conceptattention_torch.experiments.perturbation import IMAGENET_MEAN, IMAGENET_STD
    from conceptattention_torch.models.vit import vit_forward
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    @_full_f32()
    def classify(a):
        return vit_forward(params, cfg, a)[0]

    fill = torch.from_numpy(-IMAGENET_MEAN / IMAGENET_STD).to(x.device)
    out = {}
    for method in pert.CHEFER_METHODS:
        f64 = method in PERT_F64
        rel = pert.compute_vit_relevance(params64 if f64 else params, cfg,
                                         x.double() if f64 else x, method, index=labels)
        if rel.shape[-1] != x.shape[-1]:
            rel = pert.upsample_token_relevance(rel, x.shape[-1])
        for negative in (False, True):
            out[(method, negative)] = pert.run_perturbation_eval(
                classify, x, labels, rel, negative=negative, fill=fill)
    return out


def other_tie_ranks(relevance):
    """Descending ranks with ties in ascending pixel order (the control)."""
    order = torch.argsort(-relevance, dim=-1, stable=True)
    return torch.argsort(order, dim=-1)


def perturbation_path(dataset, counters):
    """The perturbation test on the card: the experiment's `run` (f32, the
    user's path) one method at a time, timed; then the sweep with f64
    relevance on the card and on the CPU, the accuracies held equal, and
    the control. No kernel of the port runs here."""
    from conceptattention_torch.evals import perturbation as pert
    from conceptattention_torch.evals.baselines import _preprocess
    from conceptattention_torch.experiments import perturbation as experiment
    from conceptattention_torch.models.flux.params import tree_map
    from conceptattention_torch.models.vit import ViTConfig, init_vit_params, vit_forward
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    torch.set_num_threads(8)
    cfg = ViTConfig()
    result = {}

    def run():
        params = init_vit_params(torch.Generator("cuda").manual_seed(0), cfg)
        x = torch.cat([_preprocess(img, cfg.image_size, "cuda") for img, _, _ in dataset])
        with torch.no_grad(), _full_f32():
            labels = vit_forward(params, cfg, x)[0].argmax(dim=-1)
        seconds, aucs = {}, {}
        for method in pert.CHEFER_METHODS:
            experiment.run(params, cfg, [(x, labels)], [method])  # warm
            rows, seconds[method] = card_seconds(
                lambda: experiment.run(params, cfg, [(x, labels)], [method]))
            aucs[method] = {row[1]: row[2] for row in rows}
        result["card f32 experiment run: seconds per method"] = seconds
        result["card f32 experiment run: AUC"] = aucs

        double = tree_map(lambda t: t.double(), params)
        card, card_secs = card_seconds(lambda: perturbation_sweep(params, double, cfg, x, labels))
        cpu_params = to_cpu(params)
        cpu, cpu_secs = card_seconds(lambda: perturbation_sweep(
            cpu_params, tree_map(lambda t: t.double(), cpu_params), cfg, x.cpu(), labels.cpu()))
        ranks = pert._pixel_ranks
        pert._pixel_ranks = other_tie_ranks
        try:
            control = perturbation_sweep(params, double, cfg, x, labels)
        finally:
            pert._pixel_ranks = ranks
        result["held"] = {
            "accuracies equal": all(np.array_equal(card[k].accuracy, cpu[k].accuracy)
                                    for k in cpu),
            "largest AUC difference": max(abs(card[k].auc - cpu[k].auc) for k in cpu),
            "largest drop difference": max(float(np.abs(card[k].target_prob_drop
                                                         - cpu[k].target_prob_drop).max())
                                            for k in cpu),
            "drop limit": PERT_DROP_LIMIT,
            "control: accuracies that differ (ties the other way)": int(sum(
                (control[k].accuracy != cpu[k].accuracy).sum() for k in cpu)),
            "control: largest drop difference": max(float(np.abs(
                control[k].target_prob_drop - cpu[k].target_prob_drop).max()) for k in cpu),
            "card seconds": card_secs, "cpu seconds": cpu_secs,
            "cpu AUC": {f"{m} {'negative' if neg else 'positive'}": cpu[(m, neg)].auc
                        for m, neg in cpu}}
        del params, double, cpu_params

    _, total, launches = counted(run, counters)
    if any(launches):
        raise AssertionError(f"perturbation: kernel launches {launches}, want none")
    held = result["held"]
    ok = (held["accuracies equal"] and held["largest drop difference"] <= PERT_DROP_LIMIT
          < held["control: largest drop difference"]
          and held["control: accuracies that differ (ties the other way)"] > 0)
    print(f"perturbation, ViT-B/16 224^2, {len(dataset)} images, 7 methods x positive / "
          f"negative x 9 steps: {json.dumps(result)}; ok={ok}; path seconds {total}", flush=True)
    if not ok:
        raise AssertionError("perturbation: the card's accuracies or drops differ from the "
                             "CPU's, or the control does not change them")
    return result


# The qualitative comparison: `compare_methods.main` over all 15
# methods on one 512^2 image with 3 concepts; its caption is the concepts'
# words, so DAAMFlux also runs 3 concepts: every flux method is one stopped
# flux-schnell forward at S = 256 txt + 1024 img + 3 = 1283.
COMPARE_CONCEPTS = ["dog", "grass", "sky"]
COMPARE_CAPTION = "dog, grass, sky"
COMPARE_FLUX_METHODS = 4


def compare_flash_phases(cfg):
    """K1 at the qualitative comparison's double block: 512^2, 3 concepts,
    256 txt rows (S=1283), B=1."""
    from conceptattention_torch.kernels import flash_saliency as fs

    gen = torch.Generator("cuda").manual_seed(8)
    args, qr, kr = joint_rows_inputs(cfg, gen, 1, 256, size=EVAL_SIZE, c=len(COMPARE_CONCEPTS))
    q, k, v, t, p, c, cross, self_attention, cos, sin = args
    s = t + p + c
    mask = fs.segment_mask(s, t, p, c, cross, self_attention, "cuda")
    flipped = (*args[:7], not self_attention, cos, sin)
    h, d = cfg.num_heads, cfg.head_dim
    return [phase_result(
        f"flash_saliency qualitative comparison double_block B=1 S={s} C={c}",
        lambda a=args: fs.fused_concept_flash_attention(*a),
        lambda a=args: fs.fused_concept_flash_attention_plain(*a),
        lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask),
        4 * d * mask.sum().item() * h, 4 * h * s * d * 2 + 2 * s * d * 4,
        COMPARE_FLUX_METHODS * cfg.depth,
        {"joint rows": slice(0, t + p), "concept rows": slice(t + p, s)},
        [("self_attention flipped", "concept rows",
          lambda _, a=flipped: fs.fused_concept_flash_attention_plain(*a)),
         ("one img key tile dropped", "joint rows",
          lambda want, a=args: drop_key_tile(want, a, t + 64 * 8))],
    )]


def qualitative_path(pipe, counters, dataset):
    """`compare_methods.main` over every name of MODEL_CHOICES on one of the
    harness's images (written to build/ as a PNG) with the flux-schnell
    pipeline; K1 must run 19 times a flux method. Returns (launches [K1, K2,
    K1 hopper, K2 hopper], seconds)."""
    import os

    import PIL.Image

    from conceptattention_torch.experiments import compare_methods

    os.makedirs("build", exist_ok=True)
    image_path, figure = "build/smoke_compare_input.png", "build/smoke_compare_methods.png"
    PIL.Image.fromarray(dataset[0][0]).save(image_path)
    argv = ["--image", image_path, "--caption", COMPARE_CAPTION, "--concepts",
            *COMPARE_CONCEPTS, "--methods", "all", "--random_weights", "--width", str(EVAL_SIZE),
            "--output", figure]
    _, seconds, launches = counted(lambda: compare_methods.main(argv, pipeline=pipe), counters)
    want = COMPARE_FLUX_METHODS * pipe.cfg.depth
    if launches != [want, 0, want, 0]:
        raise AssertionError(f"qualitative comparison: launches {launches}, want K1 {want}")
    with PIL.Image.open(figure) as fig:
        size = fig.size
    if size[0] < 16 * 64:
        raise AssertionError(f"qualitative comparison: figure {figure} of size {size}")
    print(f"qualitative comparison (compare_methods.main, 15 methods, {EVAL_SIZE}^2, concepts "
          f"{COMPARE_CONCEPTS}): figure {figure} {size}, K1 launches {launches[0]} "
          f"({pipe.cfg.depth} a flux method), seconds {seconds}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, seconds


def encoder_conv_shapes(ae_cfg, res: int) -> Counter:
    """(H, Cin, Cout) of every 3x3 conv of the NHWC encoder at `res` that the
    conv3x3 gate routes to the kernel, with its count per encode (the
    3-channel input conv, the stride-2 downsamples and the output conv stay
    on F.conv2d)."""
    shapes = []
    block_in = ae_cfg.ch
    for i_level, mult in enumerate(ae_cfg.ch_mult):
        block_out = ae_cfg.ch * mult
        for _ in range(ae_cfg.num_res_blocks):
            shapes += [(res, block_in, block_out), (res, block_out, block_out)]
            block_in = block_out
        if i_level != len(ae_cfg.ch_mult) - 1:
            res //= 2
    shapes += [(res, block_in, block_in)] * 4  # mid_block_1, mid_block_2
    return Counter(s for s in shapes if s[1] % 128 == 0 and s[2] % 128 == 0 and s[0] % 8 == 0)


def heatmaps_rms(got, want) -> float:
    return max(np_rel_rms(getattr(got, tap), getattr(want, tap))
               for tap in ("concept_heatmaps", "cross_attention_maps"))


def batch_against_sequential(pipe, images, batches, counters):
    """`encode_images` at each batch size in `batches` (1024^2, seeds
    0..B-1, shared concepts), warm, against the same images' `encode_image`
    calls, and the control: image 1 encoded with image 0's seed. Returns
    (the direct outputs, seconds per direct call, {b: readings})."""
    kw = dict(width=SIZE, height=SIZE, return_pil_heatmaps=False)
    n = max(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = [pipe.encode_image(images[i], CONCEPTS, seed=i, **kw) for i in range(n)]
    torch.cuda.synchronize()
    per_image = (time.perf_counter() - t0) / n
    control = pipe.encode_image(images[1], CONCEPTS, seed=0, **kw)
    readings = {}
    for b in batches:
        for _ in range(2):
            outs, seconds, launches = counted(
                lambda: pipe.encode_images(images[:b], CONCEPTS, seeds=list(range(b)), **kw),
                counters)
        for o in outs:
            check_image_output(o, f"encode_images batch {b}")
        readings[b] = dict(errs=[heatmaps_rms(o, direct[i]) for i, o in enumerate(outs)],
                           control=heatmaps_rms(outs[1], control), launches=launches,
                           seconds=seconds)
    return direct, per_image, readings


def encode_images_path(pipe, counters):
    """`encode_images` at batch 2 and 4 against sequential `encode_image`
    calls on the flux-schnell pipeline, then the witness: the same on the
    plain attention in bf16 at full depth and at ENCODE_WITNESS_DEPTH double
    blocks in bf16 and f32 (random init, one seed). Counters are [K1, K2, K1
    hopper, K2 hopper]. Returns {path: (launches, seconds)}."""
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.config import configs
    from conceptattention_torch.models.flux.params import tree_map

    depth = pipe.cfg.depth
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(4)]
    direct, per_image_direct, fused = batch_against_sequential(pipe, images, (2, 4), counters)
    one = pipe.encode_images(images[:1], CONCEPTS, seeds=[0], width=SIZE, height=SIZE,
                             return_pil_heatmaps=False)[0]
    ok = all(np.array_equal(getattr(one, tap), getattr(direct[0], tap))
             for tap in ("concept_heatmaps", "cross_attention_maps"))
    print(f"encode_images batch 1 against encode_image: bit for bit {ok}", flush=True)
    paths = {}
    for b, r in fused.items():
        if r["launches"] != [depth, 0, depth, 0]:
            raise AssertionError(f"encode_images batch {b}: launches {r['launches']}")
        ok = ok and max(r["errs"]) <= ENCODE_IMAGES_LIMIT < r["control"]
        print(f"encode_images batch {b} {SIZE}x{SIZE}: launches [K1, K2, K1 hopper, K2 hopper] "
              f"{r['launches']}, warm seconds {r['seconds']:.4f}, seconds per image "
              f"{r['seconds'] / b:.4f} (encode_image {per_image_direct:.4f}); heatmaps vs "
              f"encode_image relative RMS {r['errs']}, control (image 1 with image 0's seed) "
              f"{r['control']}, limit {ENCODE_IMAGES_LIMIT}", flush=True)
        paths[f"encode_images (batch {b})"] = (r["launches"], r["seconds"])

    name = f"{pipe.model_name}-encode-witness"
    spec = configs[pipe.model_name]
    configs[name] = dataclasses.replace(spec, name=name, params=dataclasses.replace(
        spec.params, depth=ENCODE_WITNESS_DEPTH, depth_single_blocks=1))
    same = dict(text_encoders=pipe.text_encoders, attention_backend="sdpa", device=pipe.device)
    try:
        witness = {"sdpa bf16, full depth": ConceptAttentionFluxPipeline(
            pipe.model_name, params=pipe.params, ae_params=pipe.ae_params, **same)}
        f32 = ConceptAttentionFluxPipeline(name, dtype=torch.float32, **same)
        witness[f"sdpa bf16, {ENCODE_WITNESS_DEPTH} double blocks"] = ConceptAttentionFluxPipeline(
            name, params=tree_map(lambda x: x.to(torch.bfloat16), f32.params),
            ae_params=f32.ae_params, **same)
        witness[f"sdpa f32, {ENCODE_WITNESS_DEPTH} double blocks"] = f32
        del f32
        for label, p in witness.items():
            _, _, readings = batch_against_sequential(p, images, (2, 4), counters)
            for b, r in readings.items():
                if r["launches"] != [0, 0, 0, 0]:
                    raise AssertionError(f"witness {label} batch {b}: launches {r['launches']}")
                gate = ""
                if p.dtype == torch.float32:
                    ok = ok and max(r["errs"]) <= ENCODE_IMAGES_F32_LIMIT < r["control"]
                    gate = f", limit {ENCODE_IMAGES_F32_LIMIT}"
                print(f"encode_images witness ({label}) batch {b}: heatmaps vs encode_image "
                      f"relative RMS {r['errs']}, control {r['control']}{gate}", flush=True)
    finally:
        witness = p = None
        configs.pop(name, None)
        gc.collect()
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("encode_images against encode_image: a reading or its control is "
                             "on the wrong side of the limit")
    return paths


class TimedEncoders:
    """Text encoders that add the seconds of each call to `seconds`: the
    card is synchronised before the clock starts (so no earlier work is
    counted), and the encoders return CPU tensors (so the card has finished
    the call's work when it returns)."""

    def __init__(self, inner):
        self.inner = inner
        self.t5_dim, self.clip_dim = inner.t5_dim, inner.clip_dim
        self.t5_max_length = inner.t5_max_length
        self.seconds = {"t5": 0.0, "clip": 0.0}

    def _timed(self, name, fn, prompts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(prompts)
        self.seconds[name] += time.perf_counter() - t0
        return out

    def encode_t5(self, prompts):
        return self._timed("t5", self.inner.encode_t5, prompts)

    def encode_clip(self, prompts):
        return self._timed("clip", self.inner.encode_clip, prompts)


def t5_state_dict(cfg, gen, dtype=torch.bfloat16):
    """Random HF `T5EncoderModel` weights in its key names, on the card:
    N(0, 1/fan_in) matrices (q: 1/(d_model*d_kv)), N(0, 1) embeddings,
    N(0, 0.01) bias buckets, norm scales near 1."""
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

    def r(shape, std, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    sd = {"shared.weight": r((cfg.vocab_size, d), 1.0),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              r((cfg.relative_attention_num_buckets, cfg.num_heads), 0.1),
          "encoder.final_layer_norm.weight": r((d,), 0.1, 1.0)}
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer"
        sd.update({
            f"{p}.0.layer_norm.weight": r((d,), 0.1, 1.0),
            f"{p}.0.SelfAttention.q.weight": r((inner, d), (d * cfg.d_kv) ** -0.5),
            f"{p}.0.SelfAttention.k.weight": r((inner, d), d**-0.5),
            f"{p}.0.SelfAttention.v.weight": r((inner, d), d**-0.5),
            f"{p}.0.SelfAttention.o.weight": r((d, inner), inner**-0.5),
            f"{p}.1.layer_norm.weight": r((d,), 0.1, 1.0),
            f"{p}.1.DenseReluDense.wi_0.weight": r((cfg.d_ff, d), d**-0.5),
            f"{p}.1.DenseReluDense.wi_1.weight": r((cfg.d_ff, d), d**-0.5),
            f"{p}.1.DenseReluDense.wo.weight": r((d, cfg.d_ff), cfg.d_ff**-0.5),
        })
    return sd


def clip_state_dict(cfg, gen, dtype=torch.bfloat16):
    """Random HF `CLIPTextModel` weights in its key names (`text_model.*`),
    on the card: N(0, 1/fan_in) matrices, N(0, 1) token and N(0, 0.01)
    position embeddings, small biases, norm scales near 1."""
    d = cfg.hidden_size

    def r(shape, std, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def lin(key, din, dout):
        return {f"{key}.weight": r((dout, din), din**-0.5), f"{key}.bias": r((dout,), 0.02)}

    def ln(key):
        return {f"{key}.weight": r((d,), 0.1, 1.0), f"{key}.bias": r((d,), 0.1)}

    pre = "text_model"
    sd = {f"{pre}.embeddings.token_embedding.weight": r((cfg.vocab_size, d), 1.0),
          f"{pre}.embeddings.position_embedding.weight": r((cfg.max_position_embeddings, d), 0.1),
          **ln(f"{pre}.final_layer_norm")}
    for i in range(cfg.num_layers):
        p = f"{pre}.encoder.layers.{i}"
        sd.update({**ln(f"{p}.layer_norm1"), **ln(f"{p}.layer_norm2"),
                   **lin(f"{p}.self_attn.q_proj", d, d), **lin(f"{p}.self_attn.k_proj", d, d),
                   **lin(f"{p}.self_attn.v_proj", d, d), **lin(f"{p}.self_attn.out_proj", d, d),
                   **lin(f"{p}.mlp.fc1", d, 4 * d), **lin(f"{p}.mlp.fc2", 4 * d, d)})
    return sd


def text_towers():
    """T5-XXL and the CLIP-L text tower at full width, from random state
    dicts in the HF key names through the port's converters, bf16 on the
    card; both cut to 2 layers and held against the same towers in f32 (with
    a control each); then `TorchTextEncoders` on the full towers, timed on
    one prompt and on the concepts at flux-dev's 512 tokens."""
    from conceptattention_torch.models.flux.params import param_count, tree_map
    from conceptattention_torch.models.text import t5 as t5_mod
    from conceptattention_torch.models.text.clip import (
        CLIPTextConfig,
        clip_text_encode,
        convert_clip_text_state_dict,
    )
    from conceptattention_torch.models.text.encoders import (
        TorchTextEncoders,
        WordTokenizer,
        embed_concepts,
    )
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    gen = torch.Generator("cuda").manual_seed(8)
    t0 = time.perf_counter()
    t5_cfg, clip_cfg = t5_mod.T5Config(), CLIPTextConfig()
    sd = t5_state_dict(t5_cfg, gen)
    t5 = t5_mod.convert_t5_state_dict(sd, t5_cfg, torch.bfloat16)
    del sd
    sd = clip_state_dict(clip_cfg, gen)
    clip = convert_clip_text_state_dict(sd, clip_cfg, torch.bfloat16)
    del sd
    torch.cuda.synchronize()
    print(f"text towers: T5-XXL {param_count(t5)} and CLIP-L {param_count(clip)} parameters, "
          f"random HF state dicts converted on the card in {time.perf_counter() - t0:.3f} s",
          flush=True)
    t5_tok = WordTokenizer(t5_cfg.vocab_size, eos_id=1, pad_id=0)
    clip_tok = WordTokenizer(clip_cfg.vocab_size, clip_cfg.eos_token_id, clip_cfg.eos_token_id)

    def cut(params, key):
        return {**params, key: tree_map(lambda x: x[:2], params[key])}

    t5_2, clip_2 = cut(t5, "blocks"), cut(clip, "blocks")
    t5_cfg2 = dataclasses.replace(t5_cfg, num_layers=2)
    clip_cfg2 = dataclasses.replace(clip_cfg, num_layers=2)
    t5_ids = torch.as_tensor(t5_tok([PROMPT], max_length=512)["input_ids"], device="cuda")
    clip_ids = torch.as_tensor(clip_tok([PROMPT], max_length=77)["input_ids"], device="cuda")
    with torch.inference_mode(), _full_f32():
        f32 = tree_map(lambda x: x.float(), t5_2)
        got = t5_mod.t5_encode(t5_2, t5_cfg2, t5_ids)
        want = t5_mod.t5_encode(f32, t5_cfg2, t5_ids)
        gelu, t5_mod._gelu = t5_mod._gelu, F.relu
        try:
            ctrl = t5_mod.t5_encode(f32, t5_cfg2, t5_ids)
        finally:
            t5_mod._gelu = gelu
        t5_err, t5_ctrl = rel_rms(got, want), rel_rms(ctrl, want)
        del f32, got, want, ctrl
        f32 = tree_map(lambda x: x.float(), clip_2)
        got = clip_text_encode(clip_2, clip_cfg2, clip_ids)["pooler_output"]
        want_all = clip_text_encode(f32, clip_cfg2, clip_ids)
        want = want_all["pooler_output"]
        clip_err = rel_rms(got, want)
        clip_ctrl = rel_rms(want_all["last_hidden_state"][:, -1], want)
        finite = bool(torch.isfinite(got).all())
    ok = (finite and t5_err <= TEXT_TOWER_LIMIT < t5_ctrl
          and clip_err <= TEXT_TOWER_LIMIT < clip_ctrl)
    print(f"text towers 2 layers, full width, bf16 vs f32 relative RMS: T5 {t5_err} (control, "
          f"ReLU in the gated FFN: {t5_ctrl}), CLIP pooled {clip_err} (control, pooled at the "
          f"last token: {clip_ctrl}), limit {TEXT_TOWER_LIMIT} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("bf16 text towers against f32: a reading or a control is on the "
                             "wrong side of its limit")
    del t5_2, clip_2
    enc = TorchTextEncoders(t5, t5_cfg, t5_tok, clip, clip_cfg, clip_tok, t5_max_length=512)
    seconds = {}
    for label, fn in (("T5 one prompt", lambda: enc.encode_t5([PROMPT])),
                      ("CLIP one prompt", lambda: enc.encode_clip([PROMPT])),
                      ("T5 three concepts", lambda: embed_concepts(enc, CONCEPTS))):
        out = fn()
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        if not all(bool(torch.isfinite(x).all()) for x in (out if isinstance(out, tuple) else [out])):
            raise AssertionError(f"text towers: {label} not finite")
    print(f"text encode seconds (warm, t5_max_length 512): {json.dumps(seconds)}", flush=True)
    return enc


def flux_dev_paths(enc, counters, dataset):
    """flux-dev through `TorchTextEncoders`: `generate_image` 1024^2, STEPS
    steps, guidance 3.5, cold and warm; image-to-image at strength 0.5 on
    its image, cold and warm; the watermark read back from its image; the
    NHWC encoder and the NCHW decoder on its VAE; then the per-timestep
    sweep over `dataset`. Counters are [K1, K2, K1 hopper, K2 hopper].
    Returns {path: (launches, seconds)}."""
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.utils.watermark import WATERMARK_BITS, extract_watermark

    timed = TimedEncoders(enc)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = ConceptAttentionFluxPipeline("flux-dev", text_encoders=timed, init_seed=0)
    torch.cuda.synchronize()
    cfg = pipe.cfg
    print(f"flux-dev pipeline init seconds {time.perf_counter() - t0:.3f}", flush=True)
    per_step = cfg.depth + cfg.depth_single_blocks
    gen_kw = dict(width=SIZE, height=SIZE, num_inference_steps=STEPS, guidance=3.5,
                  return_pil_heatmaps=False, return_image_array=True)
    paths = {}

    def run(label, fn, want):
        for attempt in ("cold", "warm"):
            timed.seconds = {"t5": 0.0, "clip": 0.0}
            out, seconds, launches = counted(fn, counters)
            if launches != want:
                raise AssertionError(f"{label}: launches {launches} != {want}")
            check_image_output(out, label)
            print(f"{label} {attempt}: launches [K1, K2, K1 hopper, K2 hopper] {launches}, "
                  f"seconds {seconds:.4f}, of which T5 {timed.seconds['t5']:.4f} and CLIP "
                  f"{timed.seconds['clip']:.4f}", flush=True)
        paths[label] = (launches, seconds)
        return out

    conv = sum(decoder_conv_shapes(pipe.spec.ae_params, SIZE // 8).values())
    out = run("generate_image (flux-dev)", lambda: pipe.generate_image(PROMPT, CONCEPTS, **gen_kw),
              [STEPS * per_step + 1, conv, STEPS * per_step + 1, conv])
    print(f"flux-dev peak device memory GiB {torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)
    steps_i2i = STEPS - int(0.5 * STEPS)
    run("generate_image (flux-dev, img2img 0.5)", lambda: pipe.generate_image(
        PROMPT, CONCEPTS, init_image=out.image, image2image_strength=0.5, **gen_kw),
        [steps_i2i * per_step + 1, conv, steps_i2i * per_step + 1, conv])
    bits = extract_watermark(out.image)
    print(f"watermark read back from the flux-dev image: {sum(map(int.__eq__, bits, WATERMARK_BITS))} "
          f"of {len(WATERMARK_BITS)} bits", flush=True)
    if bits != WATERMARK_BITS:
        raise AssertionError("extract_watermark did not recover the embedded bits")
    paths["encode_nhwc"] = vae_layout_checks(pipe, out.image, counters)
    paths["per_timestep sweep"] = per_timestep_sweep(pipe, counters, dataset)
    return paths


def vae_layout_checks(pipe, image, counters):
    """The NHWC encoder at SIZE in bf16 (K2 and K1's head-dim-512 instance)
    against the f32 NCHW encode, and the NCHW decode in f32 against the
    NHWC decode in bf16, each with the mid-attention skipped as the control.
    Returns (launches, seconds) of the counted `encode_nhwc`."""
    from conceptattention_torch.kernels.conv3x3 import conv3x3_instance
    from conceptattention_torch.models.flux import autoencoder as vae
    from conceptattention_torch.models.flux.params import tree_map
    from conceptattention_torch.pipeline.concept_pipeline import _full_f32

    cfg = pipe.spec.ae_params
    shapes = encoder_conv_shapes(cfg, SIZE)
    if any(conv3x3_instance(torch.bfloat16, cin, cout) != "hopper" for _, cin, cout in shapes):
        raise AssertionError("an encoder conv would not take the Hopper K2")
    ae16 = tree_map(lambda x: x.bfloat16(), pipe.ae_params)
    with torch.inference_mode(), _full_f32():
        x = pipe._resize_pixels(image, SIZE, SIZE)
        for _ in range(2):
            got, seconds, launches = counted(lambda: vae.encode_nhwc(ae16, cfg, x.bfloat16()),
                                             counters)
        want = [1, sum(shapes.values()), 1, sum(shapes.values())]
        if launches != want:
            raise AssertionError(f"encode_nhwc launches {launches} != {want}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = vae.encode(pipe.ae_params, cfg, x)
        torch.cuda.synchronize()
        nchw_seconds = time.perf_counter() - t0
        dec = vae.decode_nhwc(ae16, cfg, ref.bfloat16())
        dec_ref = vae.decode(pipe.ae_params, cfg, ref)
        attn_block, vae.attn_block = vae.attn_block, lambda h, p: h
        try:
            enc_ctrl = vae.encode(pipe.ae_params, cfg, x)
            dec_ctrl = vae.decode(pipe.ae_params, cfg, ref)
        finally:
            vae.attn_block = attn_block
    readings = {"encode_nhwc bf16 vs encode f32": rel_rms(got, ref),
                "control: encode without mid-attention": rel_rms(enc_ctrl, ref),
                "decode_nhwc bf16 vs decode f32": rel_rms(dec, dec_ref),
                "control: decode without mid-attention": rel_rms(dec_ctrl, dec_ref)}
    vals = list(readings.values())
    ok = (vals[0] <= VAE_LAYOUT_LIMIT < vals[1] and vals[2] <= VAE_LAYOUT_LIMIT < vals[3]
          and bool(torch.isfinite(got).all()) and tuple(got.shape) == (1, cfg.z_channels, SIZE // 8,
                                                                      SIZE // 8))
    print(f"encode_nhwc {SIZE}x{SIZE} bf16: launches [K1, K2, K1 hopper, K2 hopper] {launches}, "
          f"warm seconds {seconds:.4f} (the pipeline's f32 NCHW encode: {nchw_seconds:.4f}), "
          f"K2 per Hopper-instance shape (H, Cin, Cout): "
          f"{json.dumps({str(k): v for k, v in sorted(shapes.items())})}; relative RMS "
          f"{json.dumps(readings)}, limit {VAE_LAYOUT_LIMIT} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("NHWC / NCHW VAE layouts disagree, or a control is blind")
    return launches, seconds


_AE_KEY_NAMES = {"mid_block_1": "mid.block_1", "mid_block_2": "mid.block_2",
                 "mid_attn_1": "mid.attn_1", "w": "weight", "b": "bias", "scale": "weight"}


def official_ae_state_dict(tree, prefix=""):
    """The Flux VAE tree as a state dict in the official key names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        name = _AE_KEY_NAMES.get(k, str(k)) if isinstance(k, str) else str(k)
        out.update(official_ae_state_dict(sub, f"{prefix}.{name}" if prefix else name))
    return out


def flux_state_dict(cfg, gen, dtype=torch.bfloat16):
    """Random Flux DiT weights in the official key names, on the card:
    N(0, 1/fan_in) matrices, small biases, norm scales near 1."""
    d, m, hd = cfg.hidden_size, cfg.mlp_hidden_dim, cfg.head_dim
    sd = {}

    def r(shape, std, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def lin(key, din, dout):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = r((dout, din), din**-0.5), r((dout,), 0.02)

    lin("img_in", cfg.in_channels, d)
    lin("txt_in", cfg.context_in_dim, d)
    for key, din in (("time_in", 256), ("vector_in", cfg.vec_in_dim), ("guidance_in", 256)):
        lin(f"{key}.in_layer", din, d)
        lin(f"{key}.out_layer", d, d)
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    lin("final_layer.linear", d, cfg.in_channels)
    for i in range(cfg.depth):
        b = f"double_blocks.{i}"
        for stream, attn in (("img", "img_attn"), ("txt", "txt_attn")):
            lin(f"{b}.{stream}_mod.lin", d, 6 * d)
            lin(f"{b}.{attn}.qkv", d, 3 * d)
            sd[f"{b}.{attn}.norm.query_norm.scale"] = r((hd,), 0.1, 1.0)
            sd[f"{b}.{attn}.norm.key_norm.scale"] = r((hd,), 0.1, 1.0)
            lin(f"{b}.{attn}.proj", d, d)
            lin(f"{b}.{stream}_mlp.0", d, m)
            lin(f"{b}.{stream}_mlp.2", m, d)
    for i in range(cfg.depth_single_blocks):
        b = f"single_blocks.{i}"
        lin(f"{b}.modulation.lin", d, 3 * d)
        lin(f"{b}.linear1", d, 3 * d + m)
        lin(f"{b}.linear2", d + m, d)
        sd[f"{b}.norm.query_norm.scale"] = r((hd,), 0.1, 1.0)
        sd[f"{b}.norm.key_norm.scale"] = r((hd,), 0.1, 1.0)
    return sd


def write_safetensors(path, tensors):
    """The `.safetensors` format: an 8-byte little-endian header length, a
    JSON header of dtype, shape and byte offsets, then the raw tensors."""
    import struct

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())


CKPT_DEPTH, CKPT_SINGLE = 2, 4


def checkpoint_path(counters):
    """A flux-dev-shaped checkpoint at full width with CKPT_DEPTH double and
    CKPT_SINGLE single blocks in the official key names, bf16, and the full
    VAE in f32, written as `.safetensors` under build/; a spec registered
    here only (its own variables) names them. The pipeline is built from
    them in bf16 (each mapped tensor copied to the card and converted there;
    its leaves must equal the written tensors bit for bit) and with
    quantize="w8a8" (converted and quantized on the host: the peak of
    device memory while it is built must stay below the bf16 tree's bytes),
    and each runs a 1-step `generate_image`. Counters are [K1, K2, K1
    hopper, K2 hopper]. Returns {path: (launches, seconds)}."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.config import configs
    from conceptattention_torch.models.flux import autoencoder as vae
    from conceptattention_torch.models.flux.params import tree_leaves
    from conceptattention_torch.ops.quant import int8_gemm_layout, quantize_flux_params
    from conceptattention_torch.weights.convert import (
        convert_autoencoder_state_dict,
        convert_flux_state_dict,
        load_safetensors,
    )

    name = "flux-dev-checkpoint-smoke"
    full = configs["flux-dev"]
    cut = dataclasses.replace(full.params, depth=CKPT_DEPTH, depth_single_blocks=CKPT_SINGLE)
    configs[name] = dataclasses.replace(full, name=name, params=cut,
                                        ckpt_env_var="SMOKE_FLUX_CKPT", ae_env_var="SMOKE_AE_CKPT")
    print(f"checkpoint path: reduced {json.dumps({'model': 'flux-dev', 'depth': [full.params.depth, CKPT_DEPTH], 'depth_single_blocks': [full.params.depth_single_blocks, CKPT_SINGLE]})}",
          flush=True)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="smoke_ckpt_", dir=build))
    paths = {}
    try:
        gen = torch.Generator("cuda").manual_seed(6)
        sd = flux_state_dict(cut, gen)
        ae_sd = official_ae_state_dict(vae.init_autoencoder_params(
            torch.Generator("cuda").manual_seed(7), full.ae_params))
        tree_bytes = sum(t.numel() * t.element_size() for t in sd.values())
        flux_path, ae_path = root / "flux-dev-cut.safetensors", root / "ae.safetensors"
        t0 = time.perf_counter()
        write_safetensors(flux_path, sd)
        write_safetensors(ae_path, ae_sd)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_safetensors(str(flux_path))
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = convert_flux_state_dict(loaded, cut, torch.bfloat16)
        convert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8_gemm_layout(quantize_flux_params(host, mode="w8a8"))
        quantize_s = time.perf_counter() - t0
        del loaded, host
        print(f"checkpoint {sum(t.numel() for t in sd.values())} parameters, "
              f"{tree_bytes / 2**30:.3f} GiB bf16 + VAE f32: write seconds {write_s:.3f}, "
              f"load (map) {load_s:.4f}, convert on the host {convert_s:.3f}, quantize w8a8 on "
              f"the host {quantize_s:.3f}", flush=True)
        os.environ["SMOKE_FLUX_CKPT"], os.environ["SMOKE_AE_CKPT"] = str(flux_path), str(ae_path)
        kw = dict(width=SIZE, height=SIZE, num_inference_steps=1, guidance=3.5,
                  return_pil_heatmaps=False, return_image_array=True)
        conv = sum(decoder_conv_shapes(full.ae_params, SIZE // 8).values())
        want = [CKPT_DEPTH + CKPT_SINGLE + 1, conv, CKPT_DEPTH + CKPT_SINGLE + 1, conv]
        for mode in (False, "w8a8"):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = ConceptAttentionFluxPipeline(name, quantize=mode)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            label = f"generate_image (checkpoint {mode or 'bf16'}, 1 step)"
            if mode:
                ok = peak < tree_bytes and "qa" in pipe.params["double"]["img_mlp_in"]["w"]
                check = f"peak device memory while built {peak / 2**30:.3f} GiB < bf16 tree {tree_bytes / 2**30:.3f} GiB"
            else:
                want_tree = convert_flux_state_dict(sd, cut, torch.bfloat16)  # on the card
                leaves, want_leaves = tree_leaves(pipe.params), tree_leaves(want_tree)
                d = cut.hidden_size
                ok = (len(leaves) == len(want_leaves)
                      and all(torch.equal(a, b) for a, b in zip(leaves, want_leaves))
                      and torch.equal(pipe.params["img_in"]["w"], sd["img_in.weight"].t())
                      and torch.equal(pipe.params["double"]["img_qkv"]["w"][1].reshape(d, -1),
                                      sd["double_blocks.1.img_attn.qkv.weight"].t())
                      and torch.equal(pipe.params["single"]["mlp_out"]["w"][3],
                                      sd["single_blocks.3.linear2.weight"][:, d:].t())
                      and all(torch.equal(a, b) for a, b in zip(
                          tree_leaves(pipe.ae_params),
                          tree_leaves(convert_autoencoder_state_dict(ae_sd, full.ae_params)))))
                check = (f"peak device memory while built {peak / 2**30:.3f} GiB, "
                         f"{len(leaves)} DiT leaves and the VAE's equal the written tensors "
                         f"bit for bit")
                del want_tree, leaves, want_leaves
                sd.clear()
            out, seconds, launches = counted(lambda: pipe.generate_image(PROMPT, CONCEPTS, **kw),
                                             counters)
            check_image_output(out, label)
            ok = ok and launches == want
            print(f"checkpoint pipeline {mode or 'bf16'}: init seconds {init_s:.3f}, {check}: "
                  f"ok={ok}; {label}: launches [K1, K2, K1 hopper, K2 hopper] {launches}, "
                  f"seconds {seconds:.4f}", flush=True)
            if not ok:
                raise AssertionError(f"checkpoint path {mode or 'bf16'} failed its checks")
            paths[label] = (launches, seconds)
            del pipe, out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("SMOKE_FLUX_CKPT", None)
        os.environ.pop("SMOKE_AE_CKPT", None)
        configs.pop(name, None)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def sass_summary(lib_path) -> dict:
    """Per kernel function of a built library, from `cuobjdump -sass`: its
    instruction count, its I2F (integer to float conversion) count, and a
    digest of its instructions without addresses and encodings (equal
    digests: the same machine code)."""
    import hashlib
    import re
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": "not found"}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        # without the per-build hash of the anonymous namespace
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", chunk.split("\n", 1)[0].strip())
        instrs = [re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
                  for line in chunk.splitlines()[1:] if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
        out[name] = {"instructions": len(instrs),
                     "I2F": sum(bool(re.search(r"\bI2F\b", i)) for i in instrs),
                     "digest": hashlib.sha256("\n".join(instrs).encode()).hexdigest()[:16]}
    return out


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
        fused_concept_flash_attention_int8_hopper,
        fused_concept_flash_attention_paired,
    )
    from conceptattention_torch.kernels.ring_rdma import ring_attention_rdma
    from conceptattention_torch.models.video.dit import cogvideox_5b_config

    t0 = time.perf_counter()
    logs = _build.build(["flash_saliency", "flash_saliency_sm90", "flash_saliency_int8",
                         "flash_saliency_int8_sm90", "conv3x3", "conv3x3_sm90", "ring_attention",
                         "ring_attention_sm90"])
    print(f"build seconds {time.perf_counter() - t0:.3f}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "Performance Loss")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    for name in HOPPER_SOURCES:
        print(f"sass {name}: {json.dumps(sass_summary(_build.library_path(name)))}", flush=True)

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
    # The flux-dev paths decode four more images (generate_image, its
    # img2img, and the two checkpoint pipelines' 1-step generate_image), and
    # encode_nhwc runs the encoder's mid-attention once.
    dev_decodes = 4
    flash = flash_phases(cfg, n_double, n_single, decodes + dev_decodes + 1)
    dev_cfg = configs["flux-dev"].params
    i2i_steps = STEPS - int(0.5 * STEPS)
    flash += new_shape_flash_phases(cfg, {
        "dev double": (STEPS + i2i_steps) * dev_cfg.depth + 2 * CKPT_DEPTH,
        "dev single": (STEPS + i2i_steps) * dev_cfg.depth_single_blocks + 2 * CKPT_SINGLE,
        "double b2": cfg.depth, "double b4": cfg.depth})
    flash += eval_flash_phases(cfg)
    flash += sweep_flash_phases(cfg)
    flash += compare_flash_phases(cfg)
    # K1b: generate_image (batch 1) and generate_images (batch 2) with w8a8
    # + int8_qk, and encode_image with int8_qk.
    int8 = int8_flash_phases(cfg, {
        "double": STEPS * cfg.depth + cfg.depth, "double b2": STEPS * cfg.depth,
        "single": STEPS * cfg.depth_single_blocks, "single b2": STEPS * cfg.depth_single_blocks})
    conv_counts = decoder_conv_shapes(spec.ae_params, SIZE // 8)
    conv = conv_phases(Counter({shape: (decodes + dev_decodes) * n for shape, n in conv_counts.items()})
                       + encoder_conv_shapes(spec.ae_params, SIZE))
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
    new_paths = encode_images_path(pipe, counters)
    eval_paths, dataset = eval_path(pipe, counters)
    new_paths.update(eval_paths)
    new_paths["per_layer sweep"] = per_layer_sweep(pipe, counters, dataset)
    vit_family_path(dataset, counters)
    sd_unet_path(dataset, counters)
    perturbation_path(dataset, counters)
    new_paths["qualitative comparison"] = qualitative_path(pipe, counters, dataset)
    names = ["flash_saliency", "conv3x3", "flash_saliency (Hopper instance)", "conv3x3 (Hopper instance)"]
    print("launches per kernel instance: " + json.dumps({
        "generate_image": dict(zip(names, want_gen)),
        "encode_image": dict(zip(names, [cfg.depth, 0, cfg.depth, 0]))}), flush=True)
    int8_counters = [fused_concept_flash_attention, fused_concept_flash_attention_int8,
                     conv3x3_same] + hopper + [fused_concept_flash_attention_int8_hopper]
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

    # flux-dev (23.8 GB in bf16) and T5-XXL (9.5 GB) after every earlier pipeline is released
    gc.collect()
    torch.cuda.empty_cache()
    enc = text_towers()
    new_paths.update(flux_dev_paths(enc, counters, dataset[:SWEEP_TIME_IMAGES]))
    del enc
    gc.collect()
    torch.cuda.empty_cache()
    new_paths.update(checkpoint_path(counters))
    print(f"flux surface paths (launches [K1, K2, K1 hopper, K2 hopper], seconds): "
          f"{json.dumps(new_paths)}", flush=True)

    def entry(name, source, replaces, launches, phases, per_path, also=(), **more):
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
            **{key: total(key) for key in also},  # readings summed as ms is
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
    def new_path_launches(i):
        return {k: launches[i] for k, (launches, _) in new_paths.items() if launches[i]}

    k1_paths, k1_total = per_path(0, {
        "generate_image": want_gen[0], "encode_image": cfg.depth,
        "generate_video (PAIR_HEADS off)": video_k1_bf16, "generate_video (w8a8)": video_k1_w8a8,
        "generate_image (ring_rdma)": ring_gen[1], **new_path_launches(0)})
    k1b_paths, k1b_total = per_path(1, {})
    k1b_hopper_paths, _ = per_path(5, {})
    if k1b_hopper_paths != k1b_paths:  # every flux K1b launch is at head dim 128
        raise AssertionError(f"K1b launches {k1b_paths} != its Hopper instance's {k1b_hopper_paths}")
    k2_paths, k2_total = per_path(2, {"generate_image": want_gen[1],
                                      "generate_image (ring_rdma)": ring_gen[2],
                                      **new_path_launches(1)})
    k4_paths = {label: launches[0] for label, (launches, _, _) in ring_paths.items()}
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
                  **{k: v[3] for k, v in quant_paths.items() if v[3]}, **new_path_launches(2)}),
        entry("flash_saliency_paired", "conceptattention_torch/csrc/flash_saliency_sm90.cu",
              "conceptattention_tpu/kernels/flash_saliency.py:670", video_k3_paired, video_k3,
              {"generate_video (PAIR_HEADS on)": video_k3_paired}, also=("mma_sync_ms", "k1_ms"),
              instances={
                  "conceptattention_torch/csrc/flash_saliency_sm90.cu":
                      "head dim 64, two heads a block (Hopper; ca_flash_saliency_paired_sm90_bf16)",
                  "conceptattention_torch/csrc/flash_saliency.cu":
                      "not launched by the port; its mma.sync instance timed as mma_sync_ms"},
              hopper_launches_per_path={"generate_video (PAIR_HEADS on)": video_k3_paired}),
        entry("conv3x3", "conceptattention_torch/csrc/conv3x3_sm90.cu",
              "conceptattention_tpu/kernels/conv3x3.py:91", k2_total, conv, k2_paths, instances={
                  "conceptattention_torch/csrc/conv3x3_sm90.cu": "bf16, Cin % 64 == 0 (Hopper)",
                  "conceptattention_torch/csrc/conv3x3.cu": "f32, other bf16 channel counts"},
              hopper_launches_per_path={"generate_image": want_gen[3],
                                        "generate_image (ring_rdma)": ring_gen[4],
                                        **{k: v[4] for k, v in quant_paths.items() if v[4]},
                                        **new_path_launches(3)}),
        entry("flash_saliency_int8", "conceptattention_torch/csrc/flash_saliency_int8_sm90.cu",
              "conceptattention_tpu/kernels/flash_saliency.py:305 (int8_qk)", k1b_total, int8,
              k1b_paths, also=("mma_sync_ms", "prepass_ms", "k1_ms"), instances={
                  "conceptattention_torch/csrc/flash_saliency_int8_sm90.cu":
                      "head dim 128 (Hopper), after the pre-pass of flash_saliency_int8.cu",
                  "conceptattention_torch/csrc/flash_saliency_int8.cu":
                      "the pre-pass; head dims 32, 64 (mma.sync; its 128 instance timed as "
                      "mma_sync_ms)"},
              hopper_launches_per_path=k1b_hopper_paths),
        entry("ring_attention", "conceptattention_torch/csrc/ring_attention_sm90.cu",
              "conceptattention_tpu/kernels/ring_rdma.py:215", sum(k4_paths.values()), ring,
              k4_paths, also=("steps_ms", "mma_sync_ms", "mma_sync_steps_ms"), instances={
                  "conceptattention_torch/csrc/ring_attention_sm90.cu":
                      "head dims 64, 128 (Hopper step kernel)",
                  "conceptattention_torch/csrc/ring_attention.cu":
                      "head dim 32 (mma.sync) and the hop; its 64, 128 instances timed as "
                      "mma_sync_ms / mma_sync_steps_ms"},
              hopper_step_launches_per_path={
                  label: hopper for label, (_, _, hopper) in ring_paths.items()}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
