"""The control of the check that decides ``correct``, at a cell's own size.

    python3 slambench/control.py --workload <cell> --seeds <a,b,c> --seconds <s>

For each seed, one run of the cell as ``run.py`` makes it (set-up, window,
check), with the reference in bfloat16 (its correlation sums, its match maps
and its pose-graph solve) put in the program's place on the same sampled
steps and closures and judged by the same limits: the ``control`` line of
each run holds its numbers and its verdict, the ``check`` line and the
result line the program's. All seeds run in one process. The last line
gives both verdicts for every seed. Exits 0 only where the control comes out
not correct on every seed and the program correct; 1 where the control
passed on a seed, 2 where the program failed on one. Needs the card.
"""

import json
import os
import sys
import time

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

if __name__ == "__main__":
    import argparse
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lib.harness import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    a = ap.parse_args()
    verdicts, rc = [], 0
    for seed in a.seeds.split(","):
        print(f"== seed {seed}", flush=True)
        rc |= run(["--workload", a.workload, "--seed", seed, "--seconds", a.seconds,
                   "--trace", "0"], time.perf_counter(), _control=verdicts)
    print(json.dumps({"verdicts": verdicts}), flush=True)
    if rc or len(verdicts) != len(a.seeds.split(",")):
        sys.exit(rc or 3)
    if any(v["control_correct"] for v in verdicts):
        sys.exit(1)
    sys.exit(2 if not all(v["correct"] for v in verdicts) else 0)
