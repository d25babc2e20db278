#!/usr/bin/env python3
"""The Gauss-Newton match kernel (K6, ``ops/cuda/gauss_newton.cu``) alone on
the card, at the shapes ``default.corridor_lap`` launches it at: the front
end's one 512² coarse map and the chain batches' 256² coarse maps at every
bucket, 1152 point slots.

    python3 scripts/torch_gn_kernel.py [--seed N]

One JSON line a shape: K6 held against the plain loop on a room scene
(``bench/gn_check``: gaps, passes, bits repeated), ``device_us`` of one
launch (a CUDA graph of 100 launches replayed between two events, median of
7), ``ms`` per wrapper call (CUDA events round 10 calls, median of 20), and
the plain loop's device time as the parent commit's programs ran it
(``plain_device_us``: a graph of 5 of its calls); then ptxas's report. Needs
a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from roborts_slam_tpu_torch.backend.processor import Backend, BackendSpec  # noqa: E402
from roborts_slam_tpu_torch.bench import gn_check  # noqa: E402
from roborts_slam_tpu_torch.bench.timing import device_us, time_ms  # noqa: E402
from roborts_slam_tpu_torch.config import SlamConfig  # noqa: E402
from roborts_slam_tpu_torch.frontend.processor import FrontendSpec  # noqa: E402
from roborts_slam_tpu_torch.ops import gauss_newton as gn  # noqa: E402
from roborts_slam_tpu_torch.ops.cuda import build  # noqa: E402
from roborts_slam_tpu_torch.ops.cuda import gauss_newton as gn_kernel  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=31)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gn_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    build.build_all()
    cfg = SlamConfig()
    fs = FrontendSpec.from_config(cfg, 10.0, cfg.derived_world_size(10.0))
    bs = BackendSpec.from_config(cfg, 10.0, fs.pub_spec)
    params = gn_check.params_of(cfg)
    for batch in (None,) + Backend._BATCH_BUCKETS:
        spec = fs.coarse_spec if batch is None else bs.coarse_spec
        probs, pts, msk, pose0 = gn_check.scene(spec, cfg.max_points, batch, a.seed, dev)
        r = gn_check.compare(spec, params, probs, pts, msk, pose0)
        run = lambda: gn_kernel.match(probs, pts, msk, pose0, spec.inv_res, params)
        plain = lambda: gn.optimize_passes_plain(spec, params, probs, pts, msk, pose0)
        r.update(held=gn_check.held(r), device_us=device_us(run), ms=time_ms(run),
                 plain_device_us=device_us(plain, launches=5))
        print(json.dumps(r), flush=True)
    print(json.dumps({"ptxas": gn_kernel.ptxas_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
