"""One run of one cell of the port's benchmark (BENCHMARK.json):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see jxlbench/main.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    HERE = os.path.dirname(os.path.abspath(__file__))
    ROOT = os.path.dirname(HERE)
    sys.path.insert(1, ROOT)
    from jxlbench.main import main

    sys.exit(main(sys.argv[1:], ROOT, T_START))
