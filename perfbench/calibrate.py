"""Readings for the limits of `correct`, in one process per cell:

    python3 perfbench/calibrate.py --workload <name> --runs program:1,2,3 control:7,8,9 \\
        [f32_plain:5] [--seconds S]

runs each named variant of the cell on each of its seeds: the program; its
control (the plain reference in float8 in the program's place); int8, the
program's own int8 path (w8a8 stacks, and int8 q and k where the program
has them); f32_plain, for the Flux cells, a witness (the program's plain
attention path in float32, which has to meet the reference to rounding).
Each gets a short window (`--seconds`; 0 is one call) and the check
against the reference, and prints one JSON line with every reading. The lower reading of a
number is the largest over the program's seeds, the upper the smallest
over the control's.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="variant:seed,seed,... with variant program, control, int8 or f32_plain")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    runs = [(v, int(s)) for item in args.runs for v, seeds in [item.split(":")]
            for s in seeds.split(",")]
    for variant, seed in runs:
        t = time.perf_counter()
        result, readings = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                            t, variant=variant, log=log)
        print(json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                          "correct": result["correct"], "readings": readings,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
