"""Profiling and tracing utilities.

Counterpart of the JAX package's `utils/profiling.py`: a device trace
(`torch.profiler`, exported as a Chrome / Perfetto trace), named wall-clock
phases fenced on the device, an operation count, and the per-call time of
a function measured over repeated calls. Besides, the spans the port opens
at its layer boundaries (`span`, `SPANS`), which a profiler session that
records shows on its host timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


BLOCK = "device_trace block"  # the annotation around the traced block
# Tiny kernels launched at the start of a card session, ahead of the block.
# On an H100 (torch 2.11, CUDA 12.8) a process that has captured and
# replayed CUDA graphs and run more work came to lose the first few kernel
# records of each later session (1 to 3 in `probe_trace.py`), whatever
# TEARDOWN_CUPTI said: a block of two kernels then traced as none.
PROLOGUE_KERNELS = 256


def kernel_events(trace_path: str) -> int:
    """The device kernel events of the traced block in a Chrome trace that
    `device_trace` wrote: those that start after the block's annotation
    does (the session's prologue is not counted)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    start = min((e["ts"] for e in events if e.get("name") == BLOCK), default=float("-inf"))
    return sum(e.get("cat") == "kernel" and e["ts"] >= start for e in events)


def _prologue() -> None:
    x = torch.zeros(1, device="cuda")
    for _ in range(PROLOGUE_KERNELS):
        x.add_(1.0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where there is a card, its kernels with
    `torch.profiler`; the trace is written to `log_dir/trace.json` (Chrome
    trace format, viewable in Perfetto) when the block ends. Yields the
    profiler (`key_averages()` for a table). The block runs under the
    annotation `BLOCK`.

    Where the card is traced, the session opens with PROLOGUE_KERNELS tiny
    kernels, finished before the block starts (they take the place of
    the records a session can lose at its start), and a block that left no
    kernel event raises RuntimeError: an empty device trace is never
    returned as a reading."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        if card:
            _prologue()
        with record_function(BLOCK):
            yield prof
    prof.export_chrome_trace(path)
    if card and not kernel_events(path):
        raise RuntimeError(f"device_trace: the card was traced but the block in {path} left no "
                           f"kernel event")


# The spans the port opens, one per layer boundary. A call of a pipeline
# holds its phases (prepare, reduce_maps, to_host), its sampler loop and
# its VAE passes; the sampler loop holds the DiT forwards.
CALL_GENERATE_IMAGES = "ca.call.generate_images"
CALL_ENCODE_IMAGES = "ca.call.encode_images"
CALL_GENERATE_VIDEO = "ca.call.generate_video"
PIPELINE_PREPARE = "ca.pipeline.prepare"
PIPELINE_REDUCE_MAPS = "ca.pipeline.reduce_maps"
PIPELINE_TO_HOST = "ca.pipeline.to_host"
SAMPLER_DENOISE = "ca.sampler.denoise"
DIT_FORWARD = "ca.dit.forward"
VAE_ENCODE = "ca.vae.encode"
VAE_DECODE = "ca.vae.decode"
SPANS = (
    CALL_GENERATE_IMAGES, CALL_ENCODE_IMAGES, CALL_GENERATE_VIDEO,
    PIPELINE_PREPARE, PIPELINE_REDUCE_MAPS, PIPELINE_TO_HOST,
    SAMPLER_DENOISE, DIT_FORWARD, VAE_ENCODE, VAE_DECODE,
)
# A span inside a layer's span, outside SPANS: the layer split of idle time
# charges the layer around it. Each pass of HunyuanVideo's token refiner,
# inside `ca.dit.forward`.
DIT_REFINER = "ca.dit.refiner"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context for the block named `name` (one of SPANS, or DIT_REFINER): while a
    `torch.profiler` session records on the calling thread (a
    `device_trace` block, say), `torch.profiler.record_function(name)`,
    whose range the trace shows on the host's timeline; otherwise a shared
    no-op context, so the block costs one check. Nothing else turns it on."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _synchronize(*trees) -> None:
    """Wait for every card that holds a tensor of `trees`."""
    for dev in {t.device for tree in trees for t in _tensors(tree)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class _PhaseHandle:
    """Yielded by PhaseTimer.phase; register tensors PRODUCED INSIDE the
    block so the phase's device work is billed to it: `ph.fence(latents)`."""

    def __init__(self, fences):
        self._fences = fences

    def fence(self, *tensors):
        self._fences.extend(tensors)


class PhaseTimer:
    """Named wall-clock phases, fenced on the device.

    `fence=` (evaluated at entry) fences a tensor (or a tree of them) made
    before the block; for tensors created inside the block, call
    `.fence(t)` on the yielded handle. At the end of the phase every card
    holding a fenced tensor is synchronized, so work queued in the phase is
    billed to it; without a fence a phase over asynchronous launches
    records only their dispatch:

        with timer.phase("denoise") as ph:
            latents = run(...)
            ph.fence(latents)
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence: Any = None):
        fences = [] if fence is None else [fence]
        t0 = time.perf_counter()
        try:
            yield _PhaseHandle(fences)
        finally:
            _synchronize(*fences)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v:.3f}s ({100 * v / max(total, 1e-9):.1f}%)" for k, v in self.times.items()]
        return "\n".join(lines)


def compiled_cost(fn: Callable, *args, **kwargs) -> Dict[str, Optional[float]]:
    """The floating-point operations of one call of `fn(*args, **kwargs)`,
    counted by `torch.utils.flop_counter.FlopCounterMode` as the call runs
    (PyTorch has no compiled executable to ask, as XLA's cost analysis is
    asked). The count covers the plain path only: the operators PyTorch
    dispatches (matmuls, convolutions, SDPA). A hand-written kernel
    launched through ctypes is invisible to it, so a function that
    launches one (the fused attention backend) is counted without that
    kernel's work; count the plain backend (`spec=ConceptAttentionSpec(
    backend="sdpa")`) for the whole. `bytes_accessed` is None: nothing
    here measures it."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": None}


def loop_rate(
    fn: Callable,
    *args,
    iters: int = 6,
    perturb: Optional[Callable] = None,
) -> float:
    """Seconds per call of `fn(*args)`: one warm call, then `iters` calls,
    call i on `perturb(i, args)`, timed between two CUDA events on the
    current stream when the first tensor argument is on a card (the
    device's own clock: launches queue ahead of the card), else with the
    host's `perf_counter`.

    `perturb(i, args) -> args` makes the iterations differ; the default
    scales the first tensor argument by (1 + i/64), steps that bf16 holds
    exactly. The perturbed arguments are made before the clock starts."""
    if perturb is None:
        def perturb(i, a):
            first = next(k for k, x in enumerate(a) if torch.is_tensor(x))
            x = a[first]
            return (*a[:first], x * torch.tensor(1.0 + i / 64.0, dtype=x.dtype, device=x.device),
                    *a[first + 1:])

    tensors = [x for x in args if torch.is_tensor(x)]
    on_card = bool(tensors) and tensors[0].device.type == "cuda"
    fn(*perturb(0, args))  # warm: builds, caches, allocator
    inputs = [perturb(i, args) for i in range(iters)]
    if on_card:
        dev = tensors[0].device
        torch.cuda.synchronize(dev)
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for a in inputs:
            fn(*a)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for a in inputs:
        fn(*a)
    return (time.perf_counter() - t0) / iters
