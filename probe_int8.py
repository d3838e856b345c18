"""Where the int8 serving path's time goes on the card, and how far random
weights let its heatmaps be compared with bf16.

Run from the root of a checkout (it takes its timer and its heatmap
comparison from `chip_smoke.py` beside it), on a machine with one CUDA card:

    python3 probe_int8.py [--out DIR]

It prints the card's name and power limit, then
1. the int8 GEMM (`torch._int_mm`) with the weight row-major and
   column-major, beside the bf16 product, at the flux linears' shapes
   (median of 7 warm runs between CUDA events);
2. the heatmaps of flux-schnell `generate_image` (1024x1024, 4 steps,
   random weights from init_seed 0) in variants one change away from the
   bf16 kernel path (the plain SDPA backend, int8 scores, w8, w8a8 and w8a8
   with int8 scores, all from the same weights), each against the bf16 run:
   per concept the relative max |d| and the IoU of the two maps thresholded
   at their means;
3. the warm seconds of the bf16 and the w8a8 + int8_qk `generate_image`, and
   `torch.profiler`'s device time per operator for one run of each, written
   to DIR (default `build/profiles/`, git-ignored) as `profile_<variant>.txt`.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time
from pathlib import Path

import torch

from chip_smoke import CONCEPTS, PROMPT, heatmap_agreement, time_ms

GEN = dict(width=1024, height=1024, num_inference_steps=4, return_pil_heatmaps=False,
           return_image_array=True)
# (M, K, N) of flux-schnell's linears at 1024x1024: the img stream's qkv
# (4096 tokens), the single block's qkv and MLP in (4352 tokens), its
# projection back (MLP out, 12288 -> 3072), at batch 2, and the concept
# stream's 3 rows (padded to 17).
GEMM_SHAPES = [(4096, 3072, 9216), (4352, 3072, 12288), (4352, 12288, 3072), (8704, 3072, 9216),
               (17, 3072, 18432)]


def gemm_layouts(dev) -> None:
    for m, k, n in GEMM_SHAPES:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev)
        w_col = w.t().contiguous().t()
        xb, wb = x.bfloat16(), w.bfloat16()
        ms = {"int8 row-major weight": time_ms(lambda: torch._int_mm(x, w)),
              "int8 column-major weight": time_ms(lambda: torch._int_mm(x, w_col)),
              "bf16": time_ms(lambda: xb @ wb)}
        print(f"GEMM M={m} K={k} N={n} ms {json.dumps(ms)}", flush=True)


def agreement(got, want) -> dict:
    return {tap: heatmap_agreement(getattr(got, tap), getattr(want, tap))
            for tap in ("concept_heatmaps", "cross_attention_maps")}


def timed_run(pipe):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.generate_image(PROMPT, CONCEPTS, **GEN)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile(pipe, label: str, out_dir: Path) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    timed_run(pipe)
    _, seconds = timed_run(pipe)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed_run(pipe)
    events = prof.key_averages()
    (out_dir / f"profile_{label}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=90))

    def device_s(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e6

    # device-side entries are the kernels; host-side ones the operators that launched them
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA and device_s(e)]
    top = {e.key[:70]: round(device_s(e), 4) for e in sorted(ops, key=device_s, reverse=True)[:12]}
    print(f"{label}: warm seconds {seconds:.4f}, kernel seconds under the profiler "
          f"{sum(map(device_s, kernels)):.4f}; operators by device time (s): {json.dumps(top)}",
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/profiles", help="directory for the profiler tables")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_int8 needs a CUDA card")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.kernels import _build
    from conceptattention_torch.ops.quant import quantize_flux_params

    _build.build(["flash_saliency", "flash_saliency_int8", "conv3x3"])
    dev = torch.device("cuda")
    gemm_layouts(dev)
    torch.cuda.empty_cache()

    pipe = ConceptAttentionFluxPipeline("flux-schnell", init_seed=0)
    base, _ = timed_run(pipe)
    again, _ = timed_run(pipe)
    print(f"bf16 against itself: {json.dumps(agreement(again, base))}", flush=True)
    variants = [("sdpa backend", dict(params=pipe.params, attention_backend="sdpa")),
                ("int8_qk", dict(params=pipe.params, int8_qk=True))]
    for mode in ("w8", "w8a8"):
        qparams = quantize_flux_params(pipe.params, mode=mode)
        variants.append((mode, dict(params=qparams)))
        if mode == "w8a8":
            variants.append(("w8a8 + int8_qk", dict(params=qparams, int8_qk=True)))
    for label, kw in variants:
        other = ConceptAttentionFluxPipeline("flux-schnell", ae_params=pipe.ae_params, **kw)
        out, _ = timed_run(other)
        print(f"{label} against bf16, same weights, prompt and seed: "
              f"{json.dumps(agreement(out, base))}", flush=True)
        del other, out
    serving = ConceptAttentionFluxPipeline("flux-schnell", params=variants[-1][1]["params"],
                                           ae_params=pipe.ae_params, int8_qk=True)
    del variants
    gc.collect()
    torch.cuda.empty_cache()
    profile(pipe, "bf16", out_dir)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    profile(serving, "w8a8_int8_qk", out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
