#!/usr/bin/env python3
"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON object; each
number that decided ``correct`` is printed beside its limit as the last
lines of standard error. See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
