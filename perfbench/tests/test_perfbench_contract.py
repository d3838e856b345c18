"""BENCHMARK.json against the benchmark's contract, and the files each
name in it finds; the harness's imports and arithmetic."""

import ast
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist_by_name(cell):
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert config["file"].startswith("perfbench/") and (ROOT / config["file"]).is_file()
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "drivers" / f"{traffic['entry']}.py").is_file()
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())["numbers"]
    assert limits and all("limit" in v for v in limits.values())
    _, _, e2e, per_layer = harness.find_cell(BENCH, cell["name"])
    for m in per_layer:
        assert harness.metric_file(m["name"]).is_file()
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_per_layer_metric_moves_a_metric_its_cells_report(cell):
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    _, _, e2e, per_layer = harness.find_cell(BENCH, cell["name"])
    reported = {m["name"] for m in e2e}
    assert reported - {"setup_s"} == set(traffic["report"])
    for m in per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    assert data["source"].startswith(config["source"]) and "assumed" in data
    assert data["dtype"] in ("bfloat16", "float32")


def test_a_run_imports_nothing_of_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.harness as h, perfbench.calibrate, perfbench.trace, perfbench.roofline\n"
        "import perfbench.drivers.generate, perfbench.drivers.video, perfbench.drivers.encode\n"
        "import perfbench.reference.flux, perfbench.reference.flux_vae, perfbench.reference.video\n"
        "import conceptattention_torch.pipeline.concept_pipeline\n"
        "import conceptattention_torch.pipeline.video_pipeline\n"
        "import glob, runpy\n"
        "[runpy.run_path(p) for p in glob.glob(%r)]\n"
        "print(','.join(h.forbidden_modules()))\n" % (str(ROOT), str(PB / "metrics" / "*.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert out == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "conceptattention_tpu_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program_or_jax(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "conceptattention_tpu", "conceptattention_torch"}


def test_percentile_and_end_to_end_kinds():
    xs = [0.1 * i for i in range(1, 101)]
    assert harness.percentile(xs, 90) == statistics.quantiles(xs, n=100)[89]
    recs = [{"units": 4, "t0": 0.0, "t1": t} for t in xs]
    assert harness.end_to_end("units_per_s", recs, 50.0) == 400 / 50.0
    assert harness.end_to_end("s_per_unit", recs, 50.0) == 50.0 / 400
    assert harness.end_to_end("call_p90_s", recs, 50.0) == harness.percentile(xs, 90)
    with pytest.raises(ValueError):
        harness.end_to_end("mean", recs, 50.0)
