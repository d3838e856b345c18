"""The traced run: one torch.profiler session over the measured window,
summarised in memory into what the per-layer metric readers take.

The summary holds the device's operations as (name, start, end) seconds
from the window's start, clipped to it; the window's length; the busy
time (the union of the device's intervals); and the work the harness
counted from shapes for the calls completed in the window. Nothing of the
trace is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

# Tiny kernels launched when the session opens, ahead of the window: a
# process that has done much work on the card can lose the first few kernel
# records of a later profiler session (seen on an H100 with torch 2.11 and
# CUDA 12.8); these take the place of the records lost.
PROLOGUE_KERNELS = 256
WINDOW = "perfbench.window"

Interval = Tuple[str, float, float]


@contextlib.contextmanager
def session(enabled: bool):
    """Yields a holder whose `.events` is set after the block: the kineto
    events of a profiler session over the block (None when not enabled)."""
    holder = type("Trace", (), {"events": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(PROLOGUE_KERNELS):
            x.add_(1.0)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            yield holder
    holder.events = prof.profiler.kineto_results.events()


def _on_card(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _is_annotation(e) -> bool:
    """A range annotated on the card's timeline (the window's own), not an
    operation that ran there."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name() == WINDOW or bool(flag and flag())


def summarise(events, work: Dict[str, float]) -> Dict:
    """The summary of one session's events (see the module's docstring)."""
    window = [e for e in events if e.name() == WINDOW and not _on_card(e)]
    if not window:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    device: List[Interval] = []
    host: List[Interval] = []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1 or _is_annotation(e) and _on_card(e):
            continue
        iv = (e.name(), (max(s, w0) - w0) * 1e-9, (min(t, w1) - w0) * 1e-9)
        (device if _on_card(e) else host).append(iv)
    if not device:
        raise RuntimeError("the card was traced but no operation ran on it in the window")
    device.sort(key=lambda x: x[1])
    busy = union(device)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in busy),
        "device": device,
        "busy": busy,
        "host": host,
        "work": dict(work),
    }


def union(intervals: Iterable[Interval]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted, disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def class_time(summary: Dict, pattern: str) -> float:
    """Seconds in which a device operation whose name matches `pattern`
    (a regular expression) ran in the window."""
    rx = re.compile(pattern)
    return sum(b - a for a, b in union(x for x in summary["device"] if rx.search(x[0])))


def breakdown(summary: Dict, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the innermost host operation running when the
    device fell idle."""
    by_name: Dict[str, float] = {}
    for name, a, b in summary["device"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = summary["busy"]
    gaps = [(busy[0][0] if busy else summary["window_s"], 0.0)]
    gaps += [(b - a, a) for (_, a), (b, _) in zip(busy, busy[1:])]
    if busy:
        gaps.append((summary["window_s"] - busy[-1][1], busy[-1][1]))
    gaps = sorted(gaps, reverse=True)[:top]
    host = sorted(summary["host"], key=lambda x: x[1])
    starts = [x[1] for x in host]
    named = []
    for length, at in gaps:
        if length <= 0:
            continue
        inner = _innermost(host, starts, at)
        named.append([f"host: {inner}", length])
    return {"device_ops": [[_short(n), s] for n, s in ops], "idle_gaps": named}


def _innermost(host: Sequence[Interval], starts: Sequence[float], at: float) -> str:
    """The host operation with the latest start among those running at `at`."""
    i = bisect.bisect_right(starts, at)
    for name, a, b in reversed(host[max(0, i - 20000):i]):
        if a <= at < b:
            return name
    return "none"


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit] + "..."


def read_metric(path, summary: Dict) -> Optional[float]:
    """Run the reader in `path` (a `read(summary)` function) on the summary."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{abs(hash(str(path)))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(summary)
