"""Each cell on the card at its own size: a short window reads `correct`
true, a traced one reads its per-layer metrics, and the cell's controls
read `correct` false. Skipped where there is no card; on the card:

    python -m pytest perfbench/tests -m cuda -p no:cacheprovider
"""

import math
import time

import pytest

from perfbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cell, trace=False, variant="program", seconds=2.0):
    import gc

    import torch

    try:
        return harness.run_cell(BENCH, cell, 2**31 + 4321, seconds, trace, time.perf_counter(),
                                variant=variant, log=lambda msg: None)[0]
    finally:
        gc.collect()
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_window_is_correct(card, cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    _, _, e2e, _ = harness.find_cell(BENCH, cell)
    assert {m["name"] for m in e2e} == set(result["metrics"])
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_window_reads_its_per_layer_metrics(card, cell):
    result = _run(cell, trace=True)
    _, _, _, per_layer = harness.find_cell(BENCH, cell)
    assert result["correct"]
    assert {m["name"] for m in per_layer} == set(result["metrics"])
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        assert 0 < m["value"] <= 105 if "roofline" in name or "mfu" in name else m["value"] >= 0
    assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    """The reference in float8 in the program's place."""
    assert not _run(cell, variant="control", seconds=0.0)["correct"]
