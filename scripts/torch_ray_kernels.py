#!/usr/bin/env python3
"""Quick bench of the port's carve and ray-check kernels on one NVIDIA GPU.

    python3 scripts/torch_ray_kernels.py

For iterating on ``roborts_slam_tpu_torch/ops/cuda/raycarve.cu``: it builds
the kernels (printing the ptxas resource report), then on scans made from a
seed — a 1081-beam lidar of 200 cells' reach in a room, packed to 1152 beams,
on the pub maps of the three shipped configurations (640², 1024², 896²) —
holds every design of the carve (``raycarve.MARK_DESIGNS``: the beam-major
one that is shipped, the tile-major one and two more beam-major ones)
against the plain version, cell for cell, and the ray check with and without
its ticket reduction against the plain counts (B = 1 and 4), and prints one
JSON line per shape: ``device_us`` per launch of each design (100 launches in
a CUDA graph, replayed between two events; the designs in turns, forwards
and backwards, the mean of the two), ``host_us`` per wrapper call and per
bare launch through the bound C function, ``ms`` per wrapper call (events
round 10 back-to-back calls). Then a few edge cases against the plain
versions, and what the pieces of one wrapper call cost on the host. About
20 s; `chip_smoke.py` is the full check on real scans.
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
from roborts_slam_tpu_torch.ops import raster, raycast          # noqa: E402
from roborts_slam_tpu_torch.ops.cuda import build, launch, raycarve  # noqa: E402

MAPS = (640, 1024, 896)
ROOM = {640: 0.4, 1024: 0.6, 896: 0.5}     # the room's scale: rays of 40-70 cells
MIN_PASSTHROUGH, OCCU_THRESHOLD, THR_D2 = 2.0, 0.5, 5


def room_scan(dev, seed, side, pose, beams=1081, packed=1152, reach=200.0,
              stretch=0.0, scale=1.0):
    """start (2,), end (packed, 2), beam_mask (packed,) of a 270° scan taken
    at ``pose`` (x, y, heading, in cells) inside a room of 300 x 200 cells
    times ``scale`` round the map's centre; ranges
    beyond ``reach`` cells are dropped. ``stretch`` cells are added to the
    ranges of every other ten beams (rays that pierce the wall)."""
    rng = np.random.default_rng(seed)
    half = np.array([150.0, 100.0]) * scale
    centre = np.array([side / 2.0, side / 2.0])
    ang = pose[2] + np.deg2rad(np.linspace(-135.0, 135.0, beams))
    ux, uy = np.cos(ang), np.sin(ang)
    rel = np.asarray(pose[:2]) - centre
    with np.errstate(divide="ignore"):
        tx = np.where(ux > 0, (half[0] - rel[0]) / ux, (-half[0] - rel[0]) / ux)
        ty = np.where(uy > 0, (half[1] - rel[1]) / uy, (-half[1] - rel[1]) / uy)
    r = np.minimum(tx, ty) + rng.normal(0.0, 0.2, beams)
    valid = r < reach
    r = r + stretch * (np.arange(beams) % 20 < 10)
    end = np.zeros((packed, 2))
    end[:beams] = np.stack([pose[0] + r * ux, pose[1] + r * uy], -1)
    mask = np.zeros(packed, bool)
    mask[:beams] = valid
    start = np.floor(np.asarray(pose[:2]) + 0.5).astype(np.int32)
    return (torch.as_tensor(start, device=dev),
            torch.as_tensor(np.floor(end + 0.5).astype(np.int32), device=dev),
            torch.as_tensor(mask, device=dev))


def host_us(fn):
    """``bench/timing.host_us`` over 300 calls."""
    return timing.host_us(fn, calls=300)


def in_turns(fns: dict) -> dict:
    """``device_us`` of every function, forwards then backwards; the mean."""
    names = list(fns)
    return timing.in_turns(device_us, fns, names + names[::-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ray_kernels: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    designs = raycarve.MARK_DESIGNS
    shipped = [k for k, v in designs.items() if v == raycarve.MARK_DESIGN][0]

    for side in MAPS:
        pose = (side / 2 - 40.0, side / 2 + 25.0, 0.3)
        room = dict(scale=ROOM[side])
        start, end, mask = room_scan(dev, 1, side, pose, **room)
        want = raster.mark_image_plain(start, end, mask, side, side)
        delta = (end - start[None]).abs().amax(-1).clamp(min=1)
        row = {"kernel": "ray_mark_image", "map": side, "beams": int(mask.sum()),
               "ray_cells": int((delta + 1)[mask].sum()), "shipped": shipped}
        bare, images = {}, {}
        for name, design in designs.items():
            images[name] = torch.full((side, side), 7, dtype=torch.int32, device=dev)
            bare[name] = raycarve.prepared_mark_launch(start, end, mask, images[name], design)
            bare[name]()
            torch.cuda.synchronize()
            differing = int((images[name] != want).sum())
            assert differing == 0, f"{name} at {side}: {differing} cells differ"
        row["device_us"] = in_turns(bare)
        # what is left of a design without a beam (the fill or the tiles'
        # zeroes alone), and with every beam masked (the beam list read too)
        spare, none = torch.empty_like(want), torch.zeros_like(mask)
        row["device_us_of_parts"] = in_turns({
            f"{name}_{part}": raycarve.prepared_mark_launch(start, e, m, spare, designs[name])
            for name in ("beam_major", "tile_major")
            for part, e, m in (("no_beam", end[:0], mask[:0]), ("every_beam_masked", end, none))})
        call = lambda: raycarve.ray_mark_image(start, end, mask, side, side)
        assert torch.equal(call(), want)
        row["host_us"] = host_us(call)
        row["bare_host_us"] = host_us(bare[row["shipped"]])
        row["ms"] = time_ms(call)
        print(json.dumps(row), flush=True)

        # a pub map from ten scans round the pose, then the check's rays
        hits = torch.zeros((side, side), device=dev)
        passes = torch.zeros((side, side), device=dev)
        for i in range(10):
            s_, e_, m_ = room_scan(dev, 10 + i, side,
                                   (pose[0] + 3 * i, pose[1] - 2 * i, pose[2] + 0.05 * i),
                                   **room)
            mark = raycarve.ray_mark_image(s_, e_, m_, side, side)
            hits += (mark == 2) * 1.7
            passes += (mark > 0) * 1.3
        for B in (1, 4):
            starts, ends, oks = [], [], []
            for b in range(B):
                s_, e_, m_ = room_scan(
                    dev, 30 + b, side,
                    (pose[0] + 6 + 2 * b, pose[1] - 5 + b, pose[2] + 0.2 + 0.4 * b),
                    stretch=8.0, **room)
                idx = torch.arange(100, device=dev) * 10
                starts.append(s_), ends.append(e_[idx]), oks.append(m_[idx])
            args = (torch.stack(starts), torch.stack(ends).contiguous(),
                    torch.stack(oks).contiguous(), hits, passes,
                    MIN_PASSTHROUGH, OCCU_THRESHOLD, THR_D2)
            want_n = raycast.bad_rays_plain(*args)
            n = (args[1] - args[0][:, None, :]).abs().amax(-1).clamp(min=1)
            row = {"kernel": "bad_ray_count", "map": side, "B": B,
                   "rays": int(args[2].sum()), "cells_on_rays": int((n + 1)[args[2]].sum()),
                   "counts": want_n.tolist()}
            bare, outs = {}, {}
            for name, ticket in (("ticket", True), ("memset_atomic", False)):
                outs[name] = torch.full((B,), 7, dtype=torch.int32, device=dev)
                bare[name] = raycarve.prepared_check_launch(*args, outs[name], ticket=ticket)
                for _ in range(3):          # the ticket must come back to 0 each time
                    bare[name]()
                    torch.cuda.synchronize()
                    assert torch.equal(outs[name], want_n), (name, side, B, outs[name], want_n)
            row["device_us"] = in_turns(bare)
            call = lambda: raycarve.bad_ray_count(*args)
            assert torch.equal(call(), want_n)
            row["host_us"] = host_us(call)
            row["bare_host_us"] = host_us(bare["ticket"])
            row["ms"] = time_ms(call)
            print(json.dumps(row), flush=True)

    # edge cases, every carve design and both reductions against the plain versions
    i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    s_, e_, m_ = room_scan(dev, 2, 128, (50.0, 70.0, 1.0), reach=60.0, scale=0.2)
    carves = {
        "non_multiple_70x101": (s_, e_, m_, 70, 101),
        "every_beam_masked": (s_, e_, torch.zeros_like(m_), 96, 128),
        "length_0_and_1": (i32([10, 12]), i32([[10, 12], [11, 12], [10, 11], [9, 13]]),
                           ones(4), 40, 48),
        "sensor_outside": (i32([-25, -10]), e_, m_, 96, 128),
        "n_above_256_on_4096": (i32([5, 17]), i32([[4090, 30], [300, 0], [4095, 17]]),
                                ones(3), 40, 4096),
        "needs_64_bits": (i32([-40000, 5]), i32([[60, 30], [100, -20], [-39990, 8]]),
                          ones(3), 40, 128),
    }
    edge = {}
    for name, (start, end, mask, H, W) in carves.items():
        want = raster.mark_image_plain(start, end, mask, H, W)
        for dname, design in designs.items():
            image = torch.full((H, W), 7, dtype=torch.int32, device=dev)
            raycarve.prepared_mark_launch(start, end, mask, image, design)()
            torch.cuda.synchronize()
            assert torch.equal(image, want), (name, dname, int((image != want).sum()))
        edge[f"carve_{name}"] = int((want > 0).sum())
        rng = np.random.default_rng(3)
        hits = torch.as_tensor(rng.random((H, W), dtype=np.float32) * 3, device=dev)
        passes = torch.as_tensor(rng.integers(0, 6, (H, W)).astype(np.float32), device=dev)
        args = (start[None].contiguous(), end[None].contiguous(), mask[None].contiguous(),
                hits, passes, 2.0, 0.3, 2)
        want_n = raycast.bad_rays_plain(*args)
        for ticket in (True, False):
            out = torch.full((1,), 7, dtype=torch.int32, device=dev)
            raycarve.prepared_check_launch(*args, out, ticket=ticket)()
            torch.cuda.synchronize()
            assert torch.equal(out, want_n), (name, ticket, out, want_n)
        edge[f"check_{name}"] = want_n.tolist()
    print(json.dumps({"edge_cases": edge}), flush=True)

    # the host's share of one wrapper call, piece by piece
    start, end, mask = room_scan(dev, 1, 1024, (472.0, 537.0, 0.3))
    pieces = {
        "plan lookup and contiguity checks":
            lambda: raycarve._mark_plan(start, end, mask, 1024, 1024, raycarve.MARK_DESIGN),
        "output allocation": lambda: start.new_empty((1024, 1024)),
        "current_device": torch.cuda.current_device,
        "stream pointer": lambda: launch.raw_stream(0),
        "four data_ptr": lambda: [t.data_ptr() for t in (start, end, mask, start)],
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
