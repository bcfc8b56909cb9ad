#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload fcn8s_parity.train --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout (``portbench/harness/runner.py`` says what
a run does). The last line of standard output is the result (JSON); the
last lines of standard error are the compared numbers, each beside its
limit.
"""

import time

_STARTED = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, _STARTED))
