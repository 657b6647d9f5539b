#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 tasq_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; exits non-zero without
them, printing no result.
"""
import time

T0 = time.perf_counter()

import sys                                                  # noqa: E402
from pathlib import Path                                    # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from tasq_bench import harness                              # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
