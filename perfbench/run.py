#!/usr/bin/env python3
"""Run one cell of the benchmark of ``admm_tpu_torch`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and per-layer metrics are found by name (``BENCHMARK.json``,
``perfbench/configs/``, ``perfbench/traffic/``, ``perfbench/limits/``,
``perfbench/metrics/``).  The last line of standard output is the result
as one JSON object; earlier lines (``# ...``) say what the card is and
what the numbers rest on; the last lines of standard error give each
number compared beside its limit.  Without enough CUDA devices, or if
the process loaded ``jax`` or ``admm_tpu``, it exits non-zero and prints
no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell name of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics from a profiler trace")
    return ap.parse_args(argv)


if __name__ == "__main__":
    from benchlib import runner

    sys.exit(runner.main(parse(), T_START))
