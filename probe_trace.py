"""Card probe: which torch.profiler sessions record the card's kernels in a
process that captures and replays CUDA graphs, beside `chip_smoke.py`
(whose phases and constants it reuses).

    python3 probe_trace.py <variant>
    for v in eager_only smoke parallel_sessions prologue; do python3 probe_trace.py $v; done

One variant a process; the environment given to the process is part of
the variant (e.g. TEARDOWN_CUPTI=0 set before Python starts):

- `eager_only`: three sessions, each around one eager K1 call (flux-schnell's
  single block, B1 H24 S=4352), as the smoke's profiling phase takes it.
- `smoke`: the model=2 tensor-parallel tree's graphed forward check (its
  own trace of a replay), then the eager K1 session: the smoke's order.
- `parallel`: the smoke's parallel phases in its order (tensor-parallel
  serving with its graphed forward and trace, the dp x sp x tp ring, FSDP x
  TP, GPipe, MoE), then the eager K1 session, as the profiling phase
  follows them; `parallel_sessions`: the same with an eager K1 session
  before the first phase and after each; `parallel_padded`: the parallel
  phases, then eager K1 sessions that wait 0.5 s (host sleep, the card
  idle) before and / or after the call, each kernel's start printed against
  its launch's (by correlation id) and against the session's window;
- `kinds`: tensor-parallel serving and the dp x sp x tp ring, then one
  session each around: the eager K1 call; a torch matmul; a torch
  elementwise add; the eager K1 call on a new stream; a replay of a small
  graph of the K1 call;
- `ring_after`: an eager K1 session, tensor-parallel serving (its graphed
  forward traced), the dp x sp x tp ring, then sessions around the eager
  K1 call and around a torch matmul; run under each CUPTI setting of the
  environment (TEARDOWN_CUPTI, DISABLE_CUPTI_LAZY_REINIT);
- `smoke_sequence`: the smoke's sessions in its order: tensor-parallel
  serving (its graphed forward traced), the ring, FSDP x TP, GPipe, MoE, the
  eager K1 session (the profiling phase), the bf16 graphed forward (traced),
  then eager K1 and torch matmul sessions; run under each CUPTI setting;
- `flush`: an eager K1 session, tensor-parallel serving, then sessions
  around the eager K1 call: as it is; followed inside the session by
  CUPTI's forced flush (`cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)`);
  followed by 20000 small torch adds; as it is again;
- `prologue`: an eager K1 session, tensor-parallel serving, then one
  bare session around the eager K1 call and three through `device_trace`
  (its prologue of tiny kernels ahead of the block), each with the events
  of the block alone;

Per session it prints the trace's device kernel events, those naming K1's
kernel, and the host's CUDA runtime and driver events. Needs one card.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs


def session(label, run, before=0.0, after=0.0):
    """One torch.profiler session (CPU and CUDA activity) around `run()`,
    `before` and `after` seconds of host sleep around it: its event counts
    by category, the device events naming K1, and per kernel its start
    less its launch's and the session's first and last host event."""
    from torch.profiler import ProfilerActivity, profile

    root = Path(tempfile.mkdtemp(prefix="probe_trace_", dir=Path(__file__).resolve().parent / "build"))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(before)
            run()
            torch.cuda.synchronize()
            time.sleep(after)
        prof.export_chrome_trace(str(root / "trace.json"))
        with open(root / "trace.json") as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cats = {}
    for e in events:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    k1 = sum(e.get("cat") == "kernel" and "flash_saliency_sm90_kernel" in e.get("name", "")
             for e in events)
    print(f"session {label}: kernel events {cats.get('kernel', 0)}, naming K1 {k1}, cuda_runtime "
          f"{cats.get('cuda_runtime', 0)}, cuda_driver {cats.get('cuda_driver', 0)}, "
          f"TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')!r}", flush=True)
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    host = [e["ts"] for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")]
    for e in events:
        if e.get("cat") == "kernel":
            corr = e.get("args", {}).get("correlation")
            print(f"  kernel {e['name'][:60]}: start - launch {e['ts'] - launches.get(corr, float('nan')):.1f} "
                  f"us; start - first host event {e['ts'] - min(host):.1f} us, last host event - "
                  f"end {max(host) - e['ts'] - e.get('dur', 0):.1f} us", flush=True)


def eager_k1(cfg):
    """The smoke's profiling phase's call: K1 at the single block, after
    its loop_rate and time_ms."""
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.utils.profiling import loop_rate

    args, _, _ = cs.single_rows_inputs(cfg, torch.Generator("cuda").manual_seed(22), 256)
    loop_rate(fs.fused_concept_flash_attention, *args, iters=7)
    cs.time_ms(lambda: fs.fused_concept_flash_attention(*args))
    return lambda: fs.fused_concept_flash_attention(*args)


def tp_pipe(pipe):
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.parallel import make_mesh

    mesh = make_mesh(model=cs.TP, devices=[torch.device("cuda", 0)] * cs.TP)
    return ConceptAttentionFluxPipeline("flux-schnell", params=pipe.params, ae_params=pipe.ae_params,
                                        mesh=mesh)


def parallel(pipe, sessions):
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper
    from conceptattention_torch.kernels.flash_saliency import (
        fused_concept_flash_attention,
        fused_concept_flash_attention_hopper,
    )

    counters = [fused_concept_flash_attention, conv3x3_same, fused_concept_flash_attention_hopper,
                conv3x3_same_hopper]
    run = eager_k1(pipe.cfg)
    bf16_out = pipe.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE,
                                   num_inference_steps=cs.STEPS, return_pil_heatmaps=False,
                                   return_image_array=True)
    conv = counters[1].launches
    phases = [("tensor-parallel serving", lambda: cs.tp_serving_path(pipe, bf16_out, counters, conv)),
              ("dp x sp x tp", lambda: cs.dp_sp_tp_path(pipe, bf16_out, counters, conv)),
              ("fsdp x tp", cs.fsdp_path), ("gpipe", lambda: cs.gpipe_path(pipe, counters)),
              ("moe", cs.moe_path)]
    if sessions:
        session("eager K1 before the phases", run)
    for name, phase in phases:
        phase()
        if sessions:
            session(f"eager K1 after {name}", run)
    if not sessions:
        session("eager K1 after the parallel phases", run)


def kinds(pipe):
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper

    counters = [fs.fused_concept_flash_attention, conv3x3_same,
                fs.fused_concept_flash_attention_hopper, conv3x3_same_hopper]
    bf16_out = pipe.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE,
                                   num_inference_steps=cs.STEPS, return_pil_heatmaps=False,
                                   return_image_array=True)
    conv = counters[1].launches
    cs.tp_serving_path(pipe, bf16_out, counters, conv)
    cs.dp_sp_tp_path(pipe, bf16_out, counters, conv)
    args, _, _ = cs.single_rows_inputs(pipe.cfg, torch.Generator("cuda").manual_seed(22), 256)
    a = torch.randn(1024, 1024, device="cuda")
    side = torch.cuda.Stream()

    def on_side():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fs.fused_concept_flash_attention(*args)
        torch.cuda.current_stream().wait_stream(side)

    fs.fused_concept_flash_attention(*args)  # warm, outside any capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fs.fused_concept_flash_attention(*args)
    for label, run in (("eager K1", lambda: fs.fused_concept_flash_attention(*args)),
                       ("torch matmul", lambda: a @ a), ("torch add", lambda: a + a),
                       ("eager K1 on a new stream", on_side), ("graph of K1", graph.replay),
                       ("eager K1 again", lambda: fs.fused_concept_flash_attention(*args))):
        session(label, run)


def ring_after(pipe):
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper

    counters = [fs.fused_concept_flash_attention, conv3x3_same,
                fs.fused_concept_flash_attention_hopper, conv3x3_same_hopper]
    run = eager_k1(pipe.cfg)
    session("eager K1 first", run)
    bf16_out = pipe.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE,
                                   num_inference_steps=cs.STEPS, return_pil_heatmaps=False,
                                   return_image_array=True)
    conv = counters[1].launches
    cs.tp_serving_path(pipe, bf16_out, counters, conv)
    session("eager K1 after tensor-parallel serving", run)
    cs.dp_sp_tp_path(pipe, bf16_out, counters, conv)
    a = torch.randn(1024, 1024, device="cuda")
    session("eager K1 after the ring", run)
    session("torch matmul after the ring", lambda: a @ a)


def smoke_sequence(pipe):
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper

    counters = [fs.fused_concept_flash_attention, conv3x3_same,
                fs.fused_concept_flash_attention_hopper, conv3x3_same_hopper]
    run = eager_k1(pipe.cfg)
    bf16_out = pipe.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE,
                                   num_inference_steps=cs.STEPS, return_pil_heatmaps=False,
                                   return_image_array=True)
    conv = counters[1].launches
    blocks = pipe.cfg.depth + pipe.cfg.depth_single_blocks

    def traced(label, fn):
        try:
            fn()
        except (RuntimeError, AssertionError) as e:
            print(f"session {label}: raised {str(e)[:200]}", flush=True)

    traced("tensor-parallel serving", lambda: cs.tp_serving_path(pipe, bf16_out, counters, conv))
    cs.dp_sp_tp_path(pipe, bf16_out, counters, conv)
    cs.fsdp_path()
    cs.gpipe_path(pipe, counters)
    cs.moe_path()
    session("eager K1 (the profiling phase)", run)
    traced("bf16 graphed forward", lambda: cs.graphed_forward_check(
        pipe, "bf16", {"flash_saliency": blocks}, cs.K1_KERNEL))
    a = torch.randn(1024, 1024, device="cuda")
    session("eager K1 after the bf16 graph", run)
    session("torch matmul last", lambda: a @ a)


def cupti_library():
    """The process's CUPTI (loaded by torch's profiler), by soname or from
    the CUDA wheel beside torch."""
    import ctypes

    try:
        return ctypes.CDLL("libcupti.so.12"), "libcupti.so.12"
    except OSError:
        path = Path(torch.__file__).parent.parent / "nvidia" / "cuda_cupti" / "lib" / "libcupti.so.12"
        return ctypes.CDLL(str(path)), str(path)


def flush(pipe):
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper

    counters = [fs.fused_concept_flash_attention, conv3x3_same,
                fs.fused_concept_flash_attention_hopper, conv3x3_same_hopper]
    run = eager_k1(pipe.cfg)
    session("eager K1 first", run)
    bf16_out = pipe.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE,
                                   num_inference_steps=cs.STEPS, return_pil_heatmaps=False,
                                   return_image_array=True)
    cs.tp_serving_path(pipe, bf16_out, counters, counters[1].launches)
    lib, name = cupti_library()
    print(f"CUPTI from {name}", flush=True)
    a = torch.randn(64, device="cuda")

    def flushed():
        run()
        torch.cuda.synchronize()
        print(f"cuptiActivityFlushAll(FORCED) returned {lib.cuptiActivityFlushAll(1)}", flush=True)

    def many():
        run()
        for _ in range(20000):
            a.add_(1.0)

    session("eager K1 after tensor-parallel serving", run)
    session("eager K1, then a forced CUPTI flush", flushed)
    session("eager K1, then 20000 adds", many)
    session("eager K1 again", run)
    session("eager K1, then a forced CUPTI flush, again", flushed)


def prologue(pipe):
    from conceptattention_torch.kernels import flash_saliency as fs
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper
    from conceptattention_torch.utils.profiling import BLOCK, device_trace, kernel_events

    counters = [fs.fused_concept_flash_attention, conv3x3_same,
                fs.fused_concept_flash_attention_hopper, conv3x3_same_hopper]
    run = eager_k1(pipe.cfg)
    session("eager K1 first", run)
    bf16_out = pipe.generate_image(cs.PROMPT, cs.CONCEPTS, width=cs.SIZE, height=cs.SIZE,
                                   num_inference_steps=cs.STEPS, return_pil_heatmaps=False,
                                   return_image_array=True)
    cs.tp_serving_path(pipe, bf16_out, counters, counters[1].launches)
    session("bare eager K1 after tensor-parallel serving", run)
    for i in range(3):
        root = Path(tempfile.mkdtemp(prefix="probe_trace_", dir=Path(__file__).resolve().parent / "build"))
        try:
            with device_trace(str(root)):
                run()
                torch.cuda.synchronize()
            with open(root / "trace.json") as f:
                events = json.load(f)["traceEvents"]
            start = min(e["ts"] for e in events if e.get("name") == BLOCK)
            named = sum(e.get("cat") == "kernel" and e["ts"] >= start
                        and "flash_saliency_sm90_kernel" in e.get("name", "") for e in events)
            print(f"session device_trace {i}: kernel events of the block {kernel_events(str(root / 'trace.json'))}, "
                  f"naming K1 {named}, all kernel events "
                  f"{sum(e.get('cat') == 'kernel' for e in events)}", flush=True)
        except RuntimeError as e:
            print(f"session device_trace {i}: raised {e}", flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)


def main(variant):
    from conceptattention_torch import ConceptAttentionFluxPipeline

    pipe = ConceptAttentionFluxPipeline("flux-schnell", init_seed=0)
    cfg = pipe.cfg
    blocks = cfg.depth + cfg.depth_single_blocks
    if variant == "eager_only":
        run = eager_k1(cfg)
        for i in range(3):
            session(f"eager K1 {i}", run)
        return
    if variant in ("kinds", "ring_after", "smoke_sequence", "flush", "prologue"):
        {"kinds": kinds, "ring_after": ring_after,
         "smoke_sequence": smoke_sequence, "flush": flush, "prologue": prologue}[variant](pipe)
        return
    if variant in ("parallel", "parallel_sessions", "parallel_padded"):
        parallel(pipe, variant == "parallel_sessions")
        if variant == "parallel_padded":
            run = eager_k1(cfg)
            for before, after in ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5), (0.0, 0.0)):
                session(f"eager K1, {before} s before, {after} s after", run, before, after)
        return
    if variant != "smoke":
        raise SystemExit(f"unknown variant {variant!r}")
    cs.graphed_forward_check(tp_pipe(pipe), "model=2 tree", {"flash_saliency": cs.TP * blocks},
                             cs.K1_KERNEL)
    session("eager K1 after the graph", eager_k1(cfg))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("probe_trace.py needs a CUDA card")
    main(sys.argv[1])
