"""Run one cell of the benchmark once; see `harness.py`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import pathlib
import sys
import time

START = time.perf_counter()
# the checkout's root instead of this folder: the program imports from
# there, and this folder's module names must not shadow others
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START))
