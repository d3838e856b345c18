"""Run one cell of the benchmark:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; what else a run reports goes to standard error.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout, so a second
# run there finds every kernel built.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_ROOT / "build" / "perfbench" / _sub)
sys.path.insert(0, str(_ROOT))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
