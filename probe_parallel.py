"""Card probes for the parallel paths and the video experiment, beside
`chip_smoke.py` (whose phases and constants it reuses).

    python3 probe_parallel.py heatmaps   # where the tensor-parallel image's heatmap error comes from
    python3 probe_parallel.py decode     # the CogVideoX-5b experiment at its default clip, --decode

`heatmaps`: flux-schnell (random weights, init_seed 0) `generate_image` at
1024², 1 and 4 steps, softmax over concepts on and off; each map's relative
RMS from the one-device fused image of the same seed: a second fused run
(is the path deterministic?), the one-device sdpa route (another bf16
order of the same function), tensor-parallel model=2, the planted fault
(saliency not summed over the ranks) and another seed.

`decode`: `run_video_concept_attention.main` with its default clip (13
latent frames of 60x90, 49 frames of 480x720) and `--decode`, steps cut
by `--num_steps` (2 here); then the decode alone on the same latents,
with the device peak above what the pipeline held before it.

Prints one line per reading; needs one card.
"""

import gc
import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def heatmaps():
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.parallel import make_mesh

    pipe = ConceptAttentionFluxPipeline("flux-schnell", init_seed=0)
    sdpa = ConceptAttentionFluxPipeline("flux-schnell", params=pipe.params, ae_params=pipe.ae_params,
                                        attention_backend="sdpa")
    tp = ConceptAttentionFluxPipeline("flux-schnell", params=pipe.params, ae_params=pipe.ae_params,
                                      mesh=make_mesh(model=cs.TP, devices=[torch.device("cuda", 0)] * cs.TP))
    taps = ("concept_heatmaps", "cross_attention_maps")
    for steps in (1, 4):
        for softmax in (True, False):
            def run(p, seed=0):
                out = p.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE, seed=seed,
                                       num_inference_steps=steps, softmax=softmax,
                                       return_pil_heatmaps=False, return_image_array=True)
                return {t: np.asarray(getattr(out, t), np.float64) for t in taps}

            ref = run(pipe)
            runs = {"second one-device fused run": run(pipe), "one-device sdpa": run(sdpa),
                    f"tensor-parallel model={cs.TP}": run(tp)}
            with cs.saliency_sum_left_out():
                runs["planted fault: saliency not summed over ranks"] = run(tp)
            runs["one-device, seed 1"] = run(pipe, seed=1)
            for name, got in runs.items():
                print(f"heatmaps steps={steps} softmax={softmax} {name}: relative RMS "
                      f"{json.dumps({t: cs.heatmap_rms(got[t], ref[t]) for t in taps})}; "
                      f"reference max |map| {json.dumps({t: float(np.abs(ref[t]).max()) for t in taps})}",
                      flush=True)
    del pipe, sdpa, tp
    gc.collect()
    torch.cuda.empty_cache()


def decode():
    from conceptattention_torch.experiments import run_video_concept_attention as exp

    out_dir = "build/probe_video"
    argv = ["--num_steps", "2", "--decode", "--output_dir", out_dir]
    args = exp.parse_args(argv)
    t0 = time.perf_counter()
    pipe = exp.build_pipeline(args)
    torch.cuda.synchronize()
    print(f"video pipeline (CogVideoX-5b, bf16) init seconds {time.perf_counter() - t0:.3f}, "
          f"held GiB {torch.cuda.memory_allocated() / 2**30:.3f}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exp.main(argv, pipeline=pipe)
    torch.cuda.synchronize()
    print(f"main {' '.join(argv)} ({args.num_frames}x{args.height}x{args.width} latents): seconds "
          f"{time.perf_counter() - t0:.3f}, frames {list(out.video_frames.shape)}, device peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f}", flush=True)
    latents = out.video_latents
    del out
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = pipe.decode_latents(latents)
    torch.cuda.synchronize()
    print(f"decode_latents alone: seconds {time.perf_counter() - t0:.3f}, frames {list(frames.shape)}, "
          f"held before GiB {held / 2**30:.3f}, peak above it GiB "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_parallel: no CUDA device", file=sys.stderr)
        return 1
    from conceptattention_torch.kernels import _build

    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    _build.build(["flash_saliency", "flash_saliency_sm90", "conv3x3", "conv3x3_sm90"])
    print(f"build seconds {time.perf_counter() - t0:.3f}", flush=True)
    for what in sys.argv[1:] or ["heatmaps", "decode"]:
        {"heatmaps": heatmaps, "decode": decode}[what]()
    print("probe_parallel: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
