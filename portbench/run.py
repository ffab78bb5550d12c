"""Run one cell of BENCHMARK.json on this machine's CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints one JSON line last on standard
output; exits non-zero, with no result, where there is no card or too few,
or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    harness.cache_environment(ROOT)
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
