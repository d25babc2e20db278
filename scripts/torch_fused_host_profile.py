#!/usr/bin/env python3
"""Where the host's time goes in the port's three engine modes on one GPU.

    python3 scripts/torch_fused_host_profile.py [--scans N]

Replays the corridor-loop log of ``chip_smoke.py``'s leg 3 (762 scans, seed
20) under ``configs/real_robot.yaml`` with the second correlation kernel
through ``SlamEngine.process``, fused, unfused and pipelined, in turns
(fused, unfused, pipelined, pipelined, unfused, fused). Each run prints its
ms per fed scan, its stage totals and the chain batches it matched; the
second run of each mode is also run under ``cProfile`` and prints the
functions with the most own time and the most cumulative time. The profiler
slows Python calls, not the device, so its figures say where the host's time
goes, not how long a scan takes. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=0, help="scans of the log (0: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from roborts_slam_tpu_torch import SlamEngine, load_config
    from roborts_slam_tpu_torch.bench.parity import corridor_loop_log
    from roborts_slam_tpu_torch.ops.cuda import build

    os.environ["ROBORTS_CORR_KERNEL"] = "2"
    build.build_all()
    log = corridor_loop_log()
    laser = log.laser
    n = args.scans or len(log)
    config = load_config(str(ROOT / "configs" / "real_robot.yaml"))
    modes = {"fused": (True, False), "unfused": (False, False), "pipelined": (True, True)}
    seen = set()
    for mode in ("fused", "unfused", "pipelined", "pipelined", "unfused", "fused"):
        fused, pipelined = modes[mode]
        eng = SlamEngine(config, laser, fused_backend=fused)
        eng.pipelined_fetch = pipelined
        prof = cProfile.Profile() if mode in seen else None
        seen.add(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        for i in range(n):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        eng.finish()
        torch.cuda.synchronize()
        if prof is not None:
            prof.disable()
        seconds = time.perf_counter() - t0
        line = {"mode": mode, "profiled": prof is not None, "scans": n,
                "ms_per_scan_fed": seconds / n * 1e3, "kept": len(eng.store),
                "fused_steps": eng.diag.fused_steps,
                "chain_dispatches": eng.backend.num_chain_dispatches,
                "stages": {k: round(v["total_s"], 3) for k, v in eng.timers.as_dict().items()}}
        print(json.dumps(line), flush=True)
        if prof is not None:
            for key in ("tottime", "cumulative"):
                out = io.StringIO()
                pstats.Stats(prof, stream=out).strip_dirs().sort_stats(key).print_stats(25)
                print(f"--- {mode}, top 25 by {key} ---\n" + out.getvalue(), flush=True)
        del eng
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
