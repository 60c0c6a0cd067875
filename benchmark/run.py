"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (without them: no result, exit code 2). See ``README.md``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the path: the benchmark's
# modules are imported as ``benchmark.*`` and shadow nothing
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_dirs()
    sys.exit(harness.main(t0=T0))
