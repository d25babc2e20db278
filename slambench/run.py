"""The benchmark of the PyTorch/CUDA SLAM engine (``roborts_slam_tpu_torch``).

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line
last: ``correct``, ``attempted`` (scans fed), ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``check``, each compared number
beside its limit. Earlier lines give each episode and the check's detail.
Without a CUDA card it exits non-zero and prints no result.
"""

import os
import sys
import time

T_START = time.perf_counter()
# one process with few threads: the host's math libraries take one core each
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lib.harness import run

    sys.exit(run(sys.argv[1:], T_START))
