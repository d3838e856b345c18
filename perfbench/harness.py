"""The benchmark's run: set up one cell, measure a closed-loop window,
check what the window produced against the plain reference, print the
result line.

Everything a cell is made of is found by the names in `BENCHMARK.json`:
the configuration's file, `traffic/<traffic>.json` (whose `entry` names the
driver module `drivers/<entry>.py`), `limits/<cell>.json` (the limit of
each number the check compares) and the reader of each per-layer metric,
`metrics/<metric>.py`, or else `metrics/<its name up to the first dot>.py`
(`mfu.py` reads `mfu.generate`, `mfu.video`, ...). A new cell needs new files and a new entry, no edit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "conceptattention_tpu")
# A call of the window that has not returned after this long is stuck (a
# kernel waiting on a barrier that never completes traps only after about
# 25 minutes): the run ends there, with no result.
CALL_DEADLINE_S = 120.0


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose whole top-level name is one of
    FORBIDDEN (the measured package's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, name: str):
    """(workload, config entry, end-to-end metrics, per-layer metrics) of one cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return (cell, config, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


class Context:
    """What a driver's `setup` gets: the parsed files, the seed, the device
    and the variant ("program"; "control", the plain reference in float8 in
    the program's place; or another that the driver names)."""

    def __init__(self, cell, config, traffic, seed, device, variant):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.variant = seed, device, variant


def metric_file(name: str) -> Path:
    """The reader of per-layer metric `name` (see the module's docstring)."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile as `statistics.quantiles(values, n=100)` cuts it."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def end_to_end(kind: str, records: List, window_s: float) -> float:
    """One end-to-end metric over the whole window: "units_per_s" (work
    completed over the window), "s_per_unit" (the window over the work
    completed), "call_pNN_s" (the NN-th percentile of every call's latency)."""
    units = sum(r["units"] for r in records)
    if kind == "units_per_s":
        return units / window_s
    if kind == "s_per_unit":
        return window_s / units
    if kind.startswith("call_p") and kind.endswith("_s"):
        return percentile([r["t1"] - r["t0"] for r in records], int(kind[6:-2]))
    raise ValueError(f"unknown end-to-end metric kind {kind!r}")


def _gpu_state() -> str:
    """The card's name, clocks, power draw and limit (`nvidia-smi`)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda", variant: str = "program",
             overrides: Optional[Dict] = None, log=print):
    """One run of one cell: (the result object (see README.md), every
    reading of the reference check, compared or not).
    `overrides` {"config": {...}, "traffic": {...}} shrink a cell for the
    CPU tests; the benchmark's own runs pass none."""
    import importlib

    import torch

    from perfbench import trace as tracing

    cell, config, e2e, per_layer = find_cell(bench, name)
    cfg = _merge(load_json(ROOT / config["file"]), (overrides or {}).get("config"))
    traffic = _merge(load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                     (overrides or {}).get("traffic"))
    limits = load_json(HERE / "limits" / f"{name}.json")["numbers"]
    driver = importlib.import_module(f"perfbench.drivers.{traffic['entry']}")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        log(f"card: {_gpu_state()}")

    t_imported = time.perf_counter()
    sut = driver.setup(Context(cell, cfg, traffic, seed, device, variant))
    requests = sut.requests()
    t_built = time.perf_counter()
    sut.warm(next(requests))
    log(f"set-up: imports {t_imported - t_process:.3f} s, weights and pipeline "
        f"{t_built - t_imported:.3f} s, warm-up call {time.perf_counter() - t_built:.3f} s")
    launches0 = _launches()

    records: List[Dict] = []
    attempted = failed = 0
    with tracing.session(trace and on_card) as tr:
        t_start = time.perf_counter()
        setup_s = t_start - t_process
        for req in requests:
            attempted += 1
            t0 = time.perf_counter()
            watchdog = threading.Timer(CALL_DEADLINE_S, _stuck, (attempted,))
            watchdog.start()
            try:
                out = sut.call(req)
            except Exception:  # a failed call counts, and the window goes on
                traceback.print_exc()
                failed += 1
                out = None
            finally:
                watchdog.cancel()
            t1 = time.perf_counter()
            if out is not None:
                records.append({"req": req, "out": out, "t0": t0, "t1": t1,
                                "units": sut.units(req)})
            if t1 - t_start >= seconds:
                break
        t_end = time.perf_counter()
    window_s = t_end - t_start
    log(f"window: {window_s:.3f} s, {attempted} calls, {failed} failed, "
        f"{sum(r['units'] for r in records)} units, setup {setup_s:.3f} s")
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items() if v != launches0.get(k)}
    log(f"kernel launches in the window: {launches}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        log(f"card: {_gpu_state()}")

    metrics = {}
    if not trace:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else end_to_end(
                traffic["report"][m["name"]], records, window_s) if records else float("nan")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if trace and on_card:
        work: Dict[str, float] = {}
        for r in records:
            for k, v in sut.work(r["req"]).items():
                work[k] = work.get(k, 0.0) + v
        summary = tracing.summarise(tr.events, work)
        tr.events = None
        for m in per_layer:
            value = tracing.read_metric(metric_file(m["name"]), summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = tracing.breakdown(summary)
        log(f"traced: busy {summary['busy_s']:.4f} s of {summary['window_s']:.4f} s; "
            f"work {work}")

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    sut.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = sut.check(records) if records else {}
    log(f"reference check: {time.perf_counter() - t_ref:.3f} s over {len(records)} calls; "
        f"readings {json.dumps(readings)}")
    checks = {}
    for key, lim in limits.items():
        value = readings.get(key, float("nan"))
        checks[key] = {"value": value, "limit": lim["limit"]}
    correct = bool(records) and failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": attempted, "failed": failed, **result,
            "checks": checks}, readings


class ForbiddenModules(RuntimeError):
    pass


def _stuck(n: int) -> None:
    print(f"call {n} of the window has not returned in {CALL_DEADLINE_S:.0f} s: stopping the "
          f"run with no result", file=sys.stderr, flush=True)
    os._exit(4)


def _launches() -> Dict[str, int]:
    from conceptattention_torch.kernels import launch_counts

    return dict(launch_counts())


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark (BENCHMARK.json).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        log(f"no BENCHMARK.json beside {HERE}")
        return 2
    bench = load_json(bench_path)
    cell, _, _, _ = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result, _ = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_process, log=log)
    except ForbiddenModules as e:
        log(f"forbidden modules loaded in the run's process: {e.args[0]}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in the run's process: {found}")
        return 3
    for key, c in result["checks"].items():
        log(f"check {key}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
