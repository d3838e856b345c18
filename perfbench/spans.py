"""The arithmetic of the per-layer metrics read from the program's spans.

The program opens `torch.profiler.record_function` ranges at its layer
boundaries while a profiler session records (`span` in
`conceptattention_torch/utils/profiling.py`), so a traced run's summary
(`trace.py`) holds them among its host intervals, on the device trace's
clock. The names are written out here, not imported: a program without the
spans reads no span, and each metric then reads None.

Each idle instant of the window (the window less the device's busy union,
what `metrics/idle_pct.py` reads) is charged to the innermost layer span
open on the host at that instant: `dit` inside a DiT forward, `vae` inside
a VAE pass, `sampler` inside a sampler loop but outside any forward,
`pipeline` inside a call of a pipeline but outside the three, and `outside`
where no call is open. The five parts sum to the window's idle time.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

CALLS = ("ca.call.generate_images", "ca.call.encode_images", "ca.call.generate_video")
LAYER_SPANS = {
    "dit": ("ca.dit.forward",),
    "vae": ("ca.vae.encode", "ca.vae.decode"),
    "sampler": ("ca.sampler.denoise",),
    "pipeline": CALLS,
}
LAYERS = tuple(LAYER_SPANS) + ("outside",)
# Of two layer spans that start at one instant, the inner one: the higher rank.
_RANK = {"pipeline": 0, "sampler": 1, "vae": 2, "dit": 3}
_LAYER_OF = {name: layer for layer, names in LAYER_SPANS.items() for name in names}
# The host's blocking waits on the card: every blocking copy and `.item()`
# ends in one of them.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# Every span name the readers read.
NAMES = tuple(_LAYER_OF)

Segment = Tuple[float, float, str]


def layer_segments(summary: Dict) -> List[Segment]:
    """The window [0, window_s] cut into (start, end, layer) pieces, each
    charged to the innermost layer span open over it ("outside" where none
    is)."""
    spans = [(a, b, _LAYER_OF[n]) for n, a, b in summary["host"] if n in _LAYER_OF and b > a]
    spans.sort(key=lambda s: s[0])
    window = summary["window_s"]
    bounds = sorted({0.0, window, *(t for a, b, _ in spans for t in (a, b))})
    out: List[Segment] = []
    open_spans: List[Segment] = []
    j = 0
    for lo, hi in zip(bounds, bounds[1:]):
        while j < len(spans) and spans[j][0] <= lo:
            open_spans.append(spans[j])
            j += 1
        open_spans = [s for s in open_spans if s[1] > lo]
        layer = max(open_spans, key=lambda s: (s[0], _RANK[s[2]]))[2] if open_spans else "outside"
        out.append((lo, hi, layer))
    return out


def _busy_until(busy: Sequence[Tuple[float, float]], starts: Sequence[float],
                before: Sequence[float], t: float) -> float:
    """Seconds of the device's busy union before `t`."""
    i = bisect.bisect_right(starts, t)
    if i == 0:
        return 0.0
    a, b = busy[i - 1]
    return before[i - 1] + min(t, b) - a


def idle_by_layer(summary: Dict) -> Dict[str, float]:
    """Idle seconds of the window charged to each of LAYERS."""
    busy = summary["busy"]
    starts = [a for a, _ in busy]
    before = [0.0]
    for a, b in busy[:-1]:
        before.append(before[-1] + b - a)
    out = dict.fromkeys(LAYERS, 0.0)
    for lo, hi, layer in layer_segments(summary):
        held = _busy_until(busy, starts, before, hi) - _busy_until(busy, starts, before, lo)
        out[layer] += (hi - lo) - held
    return out


def idle_pct(summary: Dict, layer: str) -> Optional[float]:
    """The idle time charged to `layer` as a % of the window; None where the
    window holds no span of that layer."""
    if not any(n in LAYER_SPANS[layer] for n, _, _ in summary["host"]):
        return None
    return 100.0 * idle_by_layer(summary)[layer] / summary["window_s"]


def whole_calls(summary: Dict) -> List[Tuple[float, float]]:
    """The (start, end) of each call span that lies whole in the window
    (the summary clips a host interval to [0, window_s])."""
    return sorted((a, b) for n, a, b in summary["host"]
                  if n in CALLS and 0.0 < a and b < summary["window_s"])


def host_syncs(summary: Dict) -> Optional[float]:
    """The host's synchronisations (SYNCS) that start inside a whole call
    span, per whole call span; None where the window holds none."""
    calls = whole_calls(summary)
    if not calls:
        return None
    starts = [a for a, _ in calls]
    n = 0
    for name, a, _ in summary["host"]:
        if name in SYNCS:
            i = bisect.bisect_right(starts, a)
            n += i > 0 and a < calls[i - 1][1]
    return n / len(calls)
