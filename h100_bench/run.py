"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``.  Exits
with a code other than 0, and prints no result, without CUDA cards.
"""

import os
import sys

# One process with few threads: the timed loop is host-bound, and idle
# OpenMP workers spinning beside it take the cores it runs on.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

from h100_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
