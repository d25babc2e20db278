#!/usr/bin/env python3
"""Quick bench of the port's two correlation kernels on one NVIDIA GPU.

    python3 scripts/torch_corr_kernels.py

For iterating on ``roborts_slam_tpu_torch/ops/cuda/correlation*.cu``: it
builds the kernels (printing the ptxas resource report), then on synthetic
windows from a seed — random map values, samples scattered round the sensor,
the three tiers of the simulation profile (candidate steps of 10, 2 and 1
cells) and of the real-robot profile (4, 0.8 and 0.4 cells), B = 1 and 4 —
holds both kernels against the plain version and prints one JSON line per
shape: ``device_us`` per launch of the first kernel, of the second, of the
second with no box staged (``walk``) and of the one-call ``torch.gather``
yardstick (100 launches in a CUDA graph, replayed between two events),
``host_us`` per wrapper call and per bare launch through the bound C function,
and ``ms`` per wrapper call (events round 10 back-to-back calls). Last, what
the pieces of one wrapper call cost on the host. About 20 s; `chip_smoke.py`
is the full check on real scans.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from roborts_slam_tpu_torch.bench import timing            # noqa: E402
from roborts_slam_tpu_torch.bench.timing import device_us, time_ms  # noqa: E402
from roborts_slam_tpu_torch.ops import correlative          # noqa: E402
from roborts_slam_tpu_torch.ops.cuda import build, correlation, launch  # noqa: E402

TIERS = {   # name: (angles, samples, window side, step in cells, valid samples)
    "simulation_coarse": (101, 200, 9, 10.0, 200),
    "simulation_fine": (21, 200, 11, 2.0, 200),
    "simulation_super_fine": (21, 400, 3, 1.0, 217),
    "real_robot_coarse": (101, 200, 9, 4.0, 200),
    "real_robot_fine": (21, 200, 11, 0.8, 200),
    "real_robot_super_fine": (21, 400, 3, 0.4, 217),
}


def window(dev, seed, B, A, S, N, side, step, n_valid):
    """Arguments of ``correlation_scores`` for an N x N window of ``step``
    cells in the middle of a ``side`` x ``side`` map."""
    rng = np.random.default_rng(seed)
    reach = min(1000.0, side / 2.5)
    probs = torch.as_tensor(rng.random((B, side, side), dtype=np.float32))
    rx = torch.as_tensor(rng.uniform(-reach, reach, (B, A, S)).astype(np.float32))
    ry = torch.as_tensor(rng.uniform(-reach, reach, (B, A, S)).astype(np.float32))
    svalid = torch.arange(S)[None].expand(B, S) < n_valid
    centre = torch.as_tensor(side / 2 + rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32))
    steps = torch.arange(N, dtype=torch.float32) * step
    half = (N - 1) * step * 0.5
    tensors = (probs, rx, ry, svalid, centre[:, 0:1] - half + steps,
               centre[:, 1:2] - half + steps)
    return (*[t.contiguous().to(dev) for t in tensors], 0.37,
            torch.full((B,), float(n_valid), device=dev))


def library_call(args, dev):
    """One ``torch.gather`` over precomputed indices, and the sum."""
    probs, rx, ry, sv, xs, ys, _, _ = args
    B, H, W = probs.shape
    A, S, N = rx.shape[1], rx.shape[2], xs.shape[1]
    gx = torch.floor(rx[:, :, :, None] + xs[:, None, None, :] + 0.5).long()
    gy = torch.floor(ry[:, :, :, None] + ys[:, None, None, :] + 0.5).long()
    ok = (((gx >= 0) & (gx < W))[..., :, None] & ((gy >= 0) & (gy < H))[..., None, :]
          & sv[:, None, :, None, None])
    flat = (gy[..., None, :] * W + gx[..., :, None]
            + (torch.arange(B, device=dev) * H * W)[:, None, None, None, None])
    flat = torch.where(ok, flat, 0).reshape(-1)
    flat_probs = probs.reshape(-1)
    return lambda: torch.gather(flat_probs, 0, flat).view(B, A, S, N, N).sum(2)


def host_us(fn):
    """``bench/timing.host_us`` over 300 calls."""
    return timing.host_us(fn, calls=300)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_corr_kernels: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)

    wrappers = {1: correlation.correlation_scores, 2: correlation.correlation_scores_v2}
    for side in (3072, 640):
        for tier, (A, S, N, step, n_valid) in TIERS.items():
            for B in (1, 4) if side == 640 else (1,):
                args = window(dev, 100, B, A, S, N, side, step, n_valid)
                want = correlative.correlation_scores_plain(*args)
                row = {"map": side, "tier": tier, "B": B}
                for version, fn in wrappers.items():
                    got = fn(*args)
                    assert float((got - want).abs().max()) <= 1e-5, (tier, version)
                    out = torch.empty_like(got)
                    bare = correlation.prepared_launch(version, *args, out)
                    row[f"k{version}_device_us"] = device_us(bare)
                    assert torch.equal(out, got), (tier, version)
                    row[f"k{version}_host_us"] = host_us(lambda: fn(*args))
                    row[f"k{version}_bare_host_us"] = host_us(bare)
                    row[f"k{version}_ms"] = time_ms(lambda: fn(*args))
                walked = torch.empty_like(want)
                row["k2_walk_device_us"] = device_us(correlation.prepared_launch(
                    2, *args, walked, stage_boxes=False))
                assert torch.equal(walked, out), tier
                lib = library_call(args, dev)
                row["library_device_us"] = device_us(lib)
                row["library_host_us"] = host_us(lib)
                row["library_ms"] = time_ms(lib)
                print(json.dumps(row), flush=True)

    # the host's share of one wrapper call, piece by piece
    args = window(dev, 100, 1, 21, 400, 3, 3072, 1.0, 217)
    tensors = (*args[:6], args[7])
    pieces = {
        "plan lookup and contiguity checks": lambda: correlation._plan(1, *tensors),
        "output allocation": lambda: args[1].new_empty((1, 21, 3, 3)),
        "current_device": torch.cuda.current_device,
        "stream pointer": lambda: launch.raw_stream(0),
        "stream pointer through a Stream object":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "eight data_ptr": lambda: [t.data_ptr() for t in tensors] + [args[0].data_ptr()],
    }
    for name, fn in pieces.items():
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        print(json.dumps({"host_piece": name,
                          "us": (time.perf_counter() - t0) / 2000 * 1e6}), flush=True)
    torch.cuda.synchronize()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
