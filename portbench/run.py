"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are read
from BENCHMARK.json at the root of the checkout; portbench/README.md says
how they map to files. The last line of standard output is one JSON
object; everything else goes before it or to standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's folder: the port and
# this package import by their full names
sys.path[0] = ROOT

from portbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
