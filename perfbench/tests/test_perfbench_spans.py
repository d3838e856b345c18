"""The readers of the program's spans (`perfbench/spans.py` and its metric
files) on synthetic traced-window summaries."""

import json
import random
import re

import pytest

from perfbench import harness, spans
from perfbench import trace as tracing

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]
IDLE_READERS = {"pipeline": "pipeline_idle_pct", "sampler": "sampler_idle_pct",
                "dit": "dit_idle_pct", "vae": "vae_idle_pct"}


def summary(window, busy, host):
    """A summary as `trace.summarise` makes it, from busy (start, end) pairs
    and host (name, start, end) intervals."""
    device = [("kernel", a, b) for a, b in busy]
    union = tracing.union(device)
    return {"window_s": window, "busy_s": sum(b - a for a, b in union), "device": device,
            "busy": union, "host": list(host), "work": {}}


def read(metric, s):
    return tracing.read_metric(harness.metric_file(metric), s)


def test_a_gap_half_inside_a_forward_is_split():
    s = summary(10.0, [(0.0, 2.0), (6.0, 10.0)], [
        ("ca.call.generate_images", 1.0, 9.0), ("ca.sampler.denoise", 1.5, 8.5),
        ("ca.dit.forward", 4.0, 8.0), ("aten::mm", 4.5, 5.0)])
    parts = spans.idle_by_layer(s)
    assert parts == {"dit": 2.0, "vae": 0.0, "sampler": 2.0, "pipeline": 0.0, "outside": 0.0}
    assert read("dit_idle_pct.generate", s) == pytest.approx(20.0)
    assert read("sampler_idle_pct.generate", s) == pytest.approx(20.0)
    assert read("pipeline_idle_pct.generate", s) == 0.0


def test_idle_outside_every_call_and_between_calls():
    s = summary(10.0, [(2.0, 3.0), (5.0, 6.0)], [
        ("ca.call.encode_images", 1.0, 4.0), ("ca.vae.encode", 1.5, 2.5),
        ("ca.pipeline.to_host", 3.0, 4.0), ("ca.call.encode_images", 4.5, 9.0)])
    parts = spans.idle_by_layer(s)
    # vae 1.5-2; pipeline 1-1.5, 3-4, 4.5-5, 6-9; outside 0-1, 4-4.5, 9-10
    assert parts["vae"] == pytest.approx(0.5)
    assert parts["pipeline"] == pytest.approx(0.5 + 1.0 + 0.5 + 3.0)
    assert parts["outside"] == pytest.approx(1.0 + 0.5 + 1.0)
    assert parts["dit"] == parts["sampler"] == 0.0


def _random_tree(rng, lo, hi, depth, out):
    """Layer and phase spans nested inside [lo, hi] as the program opens
    them, with other host operations among them."""
    kids = {0: ["ca.call.generate_images", "ca.call.encode_images", "ca.call.generate_video"],
            1: ["ca.sampler.denoise", "ca.vae.encode", "ca.vae.decode", "ca.pipeline.prepare",
                "ca.pipeline.reduce_maps", "ca.pipeline.to_host", "ca.dit.forward"],
            2: ["ca.dit.forward", "aten::copy_"], 3: ["aten::mm", "cudaLaunchKernel"]}
    t = lo
    while depth in kids:
        a = t + rng.uniform(0.0, (hi - lo) / 3)
        b = a + rng.uniform(0.0, (hi - lo) / 2)
        if b >= hi:
            break
        out.append((rng.choice(kids[depth]), a, b))
        _random_tree(rng, a, b, depth + 1, out)
        t = b
    return out


def _brute_force(s):
    """Idle seconds per layer from every elementary interval's midpoint."""
    names = {n: layer for layer, ns in spans.LAYER_SPANS.items() for n in ns}
    rank = {"pipeline": 0, "sampler": 1, "vae": 2, "dit": 3}
    cuts = sorted({0.0, s["window_s"], *(t for _, a, b in s["host"] for t in (a, b)),
                   *(t for a, b in s["busy"] for t in (a, b))})
    out = dict.fromkeys(spans.LAYERS, 0.0)
    for lo, hi in zip(cuts, cuts[1:]):
        mid = (lo + hi) / 2
        if any(a <= mid < b for a, b in s["busy"]):
            continue
        open_ = [(a, rank[names[n]], names[n]) for n, a, b in s["host"]
                 if n in names and a <= mid < b]
        out[max(open_)[2] if open_ else "outside"] += hi - lo
    return out


@pytest.mark.parametrize("seed", range(24))
def test_parts_sum_to_idle_pct_for_any_nesting(seed):
    rng = random.Random(seed)
    window = rng.uniform(5.0, 60.0)
    host = _random_tree(rng, -1.0 if seed % 3 == 0 else 0.0, window + (seed % 2), 0, [])
    # the summary clips host intervals to the window
    host = [(n, max(a, 0.0), min(b, window)) for n, a, b in host if b > 0.0 and a < window]
    busy = []
    t = rng.uniform(0.0, 0.5)
    while t < window:
        d = rng.uniform(0.001, 1.0)
        busy.append((t, min(t + d, window)))
        t += d + rng.expovariate(4.0)
    s = summary(window, busy, host)
    parts = spans.idle_by_layer(s)
    total = 100.0 * sum(parts.values()) / window
    assert total == pytest.approx(read("idle_pct.generate", s), abs=1e-9)
    want = _brute_force(s)
    for layer in spans.LAYERS:
        assert parts[layer] == pytest.approx(want[layer], abs=1e-9), layer
    for layer, fam in IDLE_READERS.items():
        got = read(f"{fam}.generate", s)
        if any(n in spans.LAYER_SPANS[layer] for n, _, _ in host):
            assert got == pytest.approx(100.0 * parts[layer] / window, abs=1e-9)
        else:
            assert got is None


def test_host_syncs_count_only_syncs_inside_whole_calls():
    s = summary(10.0, [(0.0, 10.0)], [
        # clipped at the window's start and end: not whole
        ("ca.call.generate_images", 0.0, 1.0), ("cudaStreamSynchronize", 0.5, 0.6),
        ("ca.call.generate_images", 9.0, 10.0), ("cudaStreamSynchronize", 9.5, 9.6),
        # two whole calls: 3 syncs of the three kinds, and other host operations
        ("ca.call.generate_images", 2.0, 4.0), ("cudaStreamSynchronize", 2.5, 2.6),
        ("cudaEventSynchronize", 3.0, 3.1), ("cudaMemcpyAsync", 3.2, 3.3),
        ("ca.call.generate_images", 5.0, 8.0), ("ca.sampler.denoise", 5.5, 7.0),
        ("cudaDeviceSynchronize", 6.0, 6.5),
        # between calls and inside a span that is not a call
        ("cudaStreamSynchronize", 4.5, 4.6), ("ca.dit.forward", 8.2, 8.8),
        ("cudaStreamSynchronize", 8.5, 8.6),
    ])
    assert read("host_syncs.generate", s) == pytest.approx(3 / 2)
    assert spans.whole_calls(s) == [(2.0, 4.0), (5.0, 8.0)]


def test_readers_read_none_without_spans():
    """A program that opens no span (the parent of the spans) reads None,
    and nothing raises."""
    s = summary(10.0, [(1.0, 2.0)], [("aten::mm", 1.0, 2.0), ("cudaStreamSynchronize", 3, 4),
                                      ("perfbench.window", 0.0, 10.0)])
    for m in SPAN_METRICS:
        assert read(m["name"], s) is None


def test_every_span_a_reader_reads_is_one_the_program_opens():
    from conceptattention_torch.utils.profiling import SPANS

    assert set(spans.NAMES) <= set(SPANS)
    assert set(spans.CALLS) == {n for n in SPANS if n.startswith("ca.call.")}
    # every layer span the program declares is read
    assert {n for n in SPANS if not n.startswith("ca.pipeline.")} == set(spans.NAMES)


def test_span_names_match_no_kernel_class():
    from conceptattention_torch.utils.profiling import SPANS

    classes = [r"flash_saliency|rope_rows", r"conv3x3", r"(?i)conv|fprop|winograd"]
    assert not [n for n in SPANS for c in classes if re.search(c, n)]


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_span_metric_entries(metric):
    family = metric["name"].split(".")[0]
    assert harness.metric_file(metric["name"]).name == f"{family}.py"
    assert len(metric["workloads"]) == 1
    unit = "syncs/call" if family == "host_syncs" else "%"
    assert metric["unit"] == unit and metric["better"] == "lower"
    layer = {"pipeline_idle_pct": "Pipelines", "host_syncs": "Pipelines",
             "sampler_idle_pct": "Samplers", "dit_idle_pct": "DiT step",
             "vae_idle_pct": "VAE convolutions"}[family]
    assert metric["layer"] == layer
