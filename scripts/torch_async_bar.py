#!/usr/bin/env python3
"""Leg 5 of ``chip_smoke.py`` alone, several times: the corridor-loop log
(762 scans, ``bench/parity.py``) as ``.rslg`` through ``run --async`` under
``configs/real_robot.yaml``, first correlation kernel, on the card.

    python3 scripts/torch_async_bar.py [--root DIR] [--runs N] [--tag NAME] [--rslg PATH]

Each run prints one JSON line: the asynchronous engine's separate chain
batches beside the JAX package's bar for it (``chain_dispatches <=
fused_misses + spa_solves + 4``, ``tests/test_engine_features.py``), the
closures, the replay's milliseconds per fed scan, the worker's time and its
largest drained batch. ``--root``: the checkout whose
``roborts_slam_tpu_torch`` runs (default: this one), so that two trees are
compared in one call on one card, in turns. ``--rslg``: where the log is
kept (simulated and written there first if it is missing, about 20 s).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--rslg", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from roborts_slam_tpu_torch import engine as tengine
    from roborts_slam_tpu_torch.__main__ import main as cli_main
    from roborts_slam_tpu_torch.bench.parity import corridor_loop_log
    from roborts_slam_tpu_torch.io.native_log import write_rslg

    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    os.environ["ROBORTS_CORR_KERNEL"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        rslg = args.rslg or os.path.join(tmp, "corridor_loop.rslg")
        if not os.path.exists(rslg):
            write_rslg(corridor_loop_log(), rslg)
        for k in range(args.runs):
            seen = {}
            orig = tengine.SlamEngine.run_stream

            def run_stream(self, source, *a, **kw):
                seen["engine"] = self
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig(self, source, *a, **kw)
                torch.cuda.synchronize()
                seen["replay_s"] = time.perf_counter() - t
                return out

            tengine.SlamEngine.run_stream = run_stream
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli_main(["run", rslg, "--config",
                                   str(root / "configs" / "real_robot.yaml"), "--async"])
            finally:
                tengine.SlamEngine.run_stream = orig
            eng = seen["engine"]
            back, diag = eng.backend, eng.diag
            bar = back.num_fused_misses + back.num_solves + 4
            print(json.dumps({
                "tag": args.tag, "run": k, "rc": rc, "device": power.strip(),
                "scans_fed": diag.scans_in, "kept": len(eng.store),
                "loop_closures": back.num_loop_closures, "spa_solves": back.num_solves,
                "chain_dispatches": back.num_chain_dispatches,
                "fused_steps": diag.fused_steps, "fused_hits": back.num_fused_hits,
                "fused_misses": back.num_fused_misses, "async_bar": bar,
                "within_async_bar": back.num_chain_dispatches <= bar,
                "replay_ms_per_scan_fed": seen["replay_s"] / diag.scans_in * 1e3,
                "frontend_s": diag.match_time_s, "backend_s": diag.backend_time_s,
                "backend_batch_max": diag.backend_batch_max,
                "finite": bool(np.isfinite(eng.trajectory_array()).all())}), flush=True)
            del eng, seen
    return 0


if __name__ == "__main__":
    sys.exit(main())
