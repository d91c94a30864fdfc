"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds saprobe_alac_tpu_torch/ and
native/.  It exits non-zero, and prints no result, without enough CUDA
cards for the cell, or if JAX or the JAX package was loaded.
"""

import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this folder, is where modules are found.
ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from benchmark import guard  # noqa: E402  (standard library only)

guard.install()

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
