#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the CUDA card of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout; harness.py says what a run does and prints.
"""

import sys
import time

_STARTED = time.perf_counter()  # set-up is timed from here

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import harness

    sys.exit(harness.main(started=_STARTED))
