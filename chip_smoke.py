#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile [DIR]]

Drives the port's main path — the blocking per-scan SLAM loop — at full
width (``configs/simulation.yaml``, 1152 points, 30 m world: a 3072² fine
map, 2432² back-end chain maps) on the scans of
``tests/data/golden_willow.npz``, builds the CUDA kernels from the sources
in this checkout, holds each kernel against its plain PyTorch version on the
card, and shows that the main path launched every kernel. Each phase prints
one JSON line; any failed phase raises and the process exits non-zero. It
needs one CUDA device and never falls back to the CPU. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
POS_TOL, ANG_TOL = 2e-3, 2e-3  # trajectory agreement bar (m, rad)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warm: int = 5, inner: int = 10) -> float:
    """Time of one ``fn`` call on the card in ms: CUDA events around a run of
    ``inner`` back-to-back calls, warm, median over ``reps`` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def bound(bytes_moved: float, operations: float):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the float32 rate. Returns (ms, which)."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = operations / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def profile_frontend(SlamEngine, config, laser, ranges, odom, times, out_dir, n=30):
    """Optional (``--profile [DIR]``): trace the per-scan loop over the first
    scans with torch.profiler, print the device-busy share and the heaviest
    device kernels, and write the table to ``DIR/profile.txt`` (default
    ``out/``)."""
    from torch.profiler import ProfilerActivity, profile

    engine = SlamEngine(config, laser, world_size=30.0)
    for i in range(5):
        engine.process(ranges[i], odom[i], float(times[i]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5, n):
            engine.process(ranges[i], odom[i], float(times[i]))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    # device rows only: an operator row repeats the time of the kernels it
    # launched, so summing every row would count the device twice
    kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(kernels, key=dev_time, reverse=True)
    busy_s = sum(dev_time(e) for e in kernels) * 1e-6
    out = ROOT / out_dir
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile.txt").write_text(avg.table(sort_by="self_cuda_time_total",
                                               row_limit=60, max_name_column_width=80))
    # the profiler slows the host side several times over, so the share is
    # also given against the unprofiled per-scan wall time of the same scans
    engine2 = SlamEngine(config, laser, world_size=30.0)
    for i in range(5):
        engine2.process(ranges[i], odom[i], float(times[i]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5, n):
        engine2.process(ranges[i], odom[i], float(times[i]))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    emit({"phase": "profile", "scans": n - 5, "profiled_wall_seconds": wall,
          "unprofiled_wall_seconds": plain_wall,
          "device_busy_seconds": busy_s,
          "device_launches": sum(e.count for e in kernels),
          "device_busy_share_of_unprofiled_wall": busy_s / plain_wall,
          "top_device_kernels": [
              {"name": e.key[:70], "calls": e.count, "device_ms": dev_time(e) * 1e-3}
              for e in rows[:12] if dev_time(e) > 0]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from roborts_slam_tpu_torch import SlamEngine, load_config
    from roborts_slam_tpu_torch.backend.processor import BackendSpec
    from roborts_slam_tpu_torch.frontend.processor import (
        FrontendSpec, init_frontend_state,
    )
    from roborts_slam_tpu_torch.models.grid_map import ProbMap, world_to_map_pose
    from roborts_slam_tpu_torch.models.scan import LaserModel, ranges_to_packed
    from roborts_slam_tpu_torch.ops import correlative, raster, raycast
    from roborts_slam_tpu_torch.ops.cuda import build, correlation, raycarve
    from roborts_slam_tpu_torch.utils.geometry import transform_points

    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- phase 1: device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc_ver = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-2]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_ver})

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})

    # ---- inputs: the willow log at full width ----
    log = np.load(ROOT / "tests" / "data" / "golden_willow.npz")
    laser = LaserModel.from_array(log["laser"])
    ranges, odom, times = log["ranges"], log["odom"], log["times"]
    n_scans = len(times)
    config = load_config(str(ROOT / "configs" / "simulation.yaml"),
                         max_points=1152, world_size=30.0)
    fspec = FrontendSpec.from_config(config, laser.range_max, 30.0)
    bspec = BackendSpec.from_config(config, laser.range_max, fspec.pub_spec)
    assert (fspec.fine_spec.height, bspec.fine_spec.height,
            fspec.pub_spec.height) == (3072, 2432, 640), "not the full width"
    packed = [ranges_to_packed(ranges[i], laser, config.max_points)
              for i in range(n_scans)]
    pts = [torch.as_tensor(p[0], device=dev) for p in packed]
    msk = [torch.as_tensor(p[1], device=dev) for p in packed]
    nvs = [p[2] for p in packed]

    # ---- phase 3: every kernel against its plain version, on the card ----
    tiers = {"coarse": fspec.matcher.coarse, "fine": fspec.matcher.fine,
             "super_fine": fspec.matcher.super_fine}
    entries = {}

    def k1_entries(spec, probs, offset, poses, points, n_valid, key):
        for tname, params in tiers.items():
            center = world_to_map_pose(offset, spec.inv_res, poses)
            grid = correlative.candidate_grid(spec, params, points, n_valid, center)
            lead = probs.shape[:-2]
            B = int(np.prod(lead)) if lead else 1
            A, S = grid.rx.shape[-2:]
            N = grid.xs.shape[-1]
            args = (probs.reshape(B, *probs.shape[-2:]),
                    grid.rx.reshape(B, A, S).contiguous(),
                    grid.ry.reshape(B, A, S).contiguous(),
                    grid.svalid.expand(B, S).contiguous(),
                    grid.xs.reshape(B, N).contiguous(),
                    grid.ys.reshape(B, N).contiguous(),
                    float(spec.default_prob),
                    torch.full((B,), grid.divisor, **f32))
            got = correlation.correlation_scores(*args)
            want = correlative.correlation_scores_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= 1e-5, f"{key}:{tname}: kernel vs plain {err}"
            assert bool(torch.isfinite(got).all())
            # yardstick: one torch.gather over precomputed indices (+ the
            # sum); timed here, called nowhere in the package
            H, W = probs.shape[-2:]
            p_, rx, ry, sv, xs, ys, _, _ = args
            gx = torch.floor(rx[:, :, :, None] + xs[:, None, None, :] + 0.5).long()
            gy = torch.floor(ry[:, :, :, None] + ys[:, None, None, :] + 0.5).long()
            ok = (((gx >= 0) & (gx < W))[..., :, None]
                  & ((gy >= 0) & (gy < H))[..., None, :]
                  & sv[:, None, :, None, None])
            flat = (gy[..., None, :] * W + gx[..., :, None]
                    + (torch.arange(B, device=dev) * H * W)[:, None, None, None, None])
            flat = torch.where(ok, flat, 0).reshape(-1)
            pf = p_.reshape(-1)
            lib = lambda: torch.gather(pf, 0, flat).view(B, A, S, N, N).sum(2)
            touched = int(torch.unique(flat[ok.reshape(-1)]).numel())
            n_samples = int(sv[0].sum())
            bytes_moved = (touched * 4 + 2 * B * A * S * 4 + B * S
                           + 2 * B * N * 4 + B * 4 + B * A * N * N * 4)
            operations = B * A * n_samples * (N * N + 4 * N)
            bms, by = bound(bytes_moved, operations)
            entries[f"{key}:{tname}"] = {
                "name": f"correlation_scores[{key}:{tname}]", "route": "cuda",
                "source": "roborts_slam_tpu_torch/ops/cuda/correlation.cu",
                "replaces": "roborts_slam_tpu/ops/pallas/correlation.py:206",
                "shape": [B, A, S, N, H, W], "launches": 0,
                "max_abs_err": err,
                "ms": time_ms(lambda: correlation.correlation_scores(*args)),
                "plain_ms": time_ms(
                    lambda: correlative.correlation_scores_plain(*args), reps=20),
                "bound_ms": bms, "bound_by": by,
                "library_ms": time_ms(lib, reps=20),
                "cells_touched": touched,
            }

    # front end: a 3072² fine map stamped with the first scans at their odometry
    state = init_frontend_state(fspec, dev)
    for i in range(0, 10):
        raster.stamp_scan(fspec.fine_spec, state.fine, pts[i], msk[i],
                          torch.as_tensor(odom[i], **f32))
    q = 12
    pose_q = torch.as_tensor(odom[q] + np.array([0.03, -0.02, 0.01]), **f32)
    k1_entries(fspec.fine_spec, state.fine.probs, state.fine.offset,
               pose_q, pts[q], nvs[q], "front_b1")

    # back end: B=4 chain maps of 2432², ten scans each
    B = 4
    chain_ids = [list(range(b, b + 10)) for b in range(B)]
    cp = torch.stack([torch.stack([pts[i] for i in c]) for c in chain_ids])
    cm = torch.stack([torch.stack([msk[i] for i in c]) for c in chain_ids])
    cpo = torch.stack([torch.as_tensor(odom[c], **f32) for c in chain_ids])
    bs = bspec.fine_spec
    size = bs.width * bs.resolution
    center = torch.as_tensor(odom[q], **f32)
    boff = torch.stack([-(center[0] - 0.5 * size), -(center[1] - 0.5 * size)])
    chain_maps = raster.stamp_scan_batch(
        bs, ProbMap(torch.full((B, bs.height, bs.width), bs.default_prob, **f32), boff),
        cp, cm, cpo, torch.ones((B, 10), dtype=torch.bool, device=dev))
    inits = pose_q[None] + torch.as_tensor(
        [[0, 0, 0], [0.02, 0, 0], [0, 0.02, 0], [0, 0, 0.01]], **f32)
    k1_entries(bs, chain_maps.probs, boff, inits, pts[q], nvs[q], "chain_b4")

    # carve: 1152 beams on the 640² pub map
    ps = fspec.pub_spec
    pub = state.pub
    start, end, beam_mask = raster._scan_cells(ps.inv_res, pub.offset, pts[q],
                                               msk[q], pose_q)
    start, end, beam_mask = start.contiguous(), end.contiguous(), beam_mask.contiguous()
    got = raycarve.ray_mark_image(start, end, beam_mask, ps.height, ps.width)
    want = raster.mark_image_plain(start, end, beam_mask, ps.height, ps.width)
    torch.cuda.synchronize()
    differing = int((got != want).sum())
    assert differing == 0, f"ray_mark_image: {differing} cells differ"
    assert int((got == 2).sum()) > 0 and int((got == 1).sum()) > 0
    delta = (end - start[None]).abs().amax(-1).clamp(min=1)
    ray_cells = int((delta + 1)[beam_mask].sum())
    bms, by = bound(ps.height * ps.width * 4 + end.numel() * 4 + beam_mask.numel() + 8,
                    ray_cells * 12)
    entries["carve"] = {
        "name": "ray_mark_image", "route": "cuda",
        "source": "roborts_slam_tpu_torch/ops/cuda/raycarve.cu",
        "replaces": "roborts_slam_tpu/ops/pallas/raycarve.py:57",
        "shape": [int(end.shape[0]), ps.height, ps.width], "launches": 0,
        "max_abs_err": float(differing),
        "ms": time_ms(lambda: raycarve.ray_mark_image(
            start, end, beam_mask, ps.height, ps.width)),
        "plain_ms": time_ms(lambda: raster.mark_image_plain(
            start, end, beam_mask, ps.height, ps.width), reps=20),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "ray_cells": ray_cells,
    }

    # check: 100 rays against a pub map carved from the first scans, B=1 and B=4
    for i in range(0, 10):
        raster.update_count_map(ps, pub, pts[i], msk[i],
                                torch.as_tensor(odom[i], **f32), 0.3, 0.7)
    thr_d2 = int(np.floor(config.map_check_bound_tolerance ** 2)) + 1
    sidx, svalid = raycast._sample_beams(pts[q], msk[q], nvs[q],
                                         config.map_check_point_num)

    def k4_args(poses):
        pose_map = world_to_map_pose(pub.offset, ps.inv_res, poses)
        e = raster._cell_round(transform_points(pose_map, pts[q][sidx] * ps.inv_res))
        s = raster._cell_round(pose_map[..., :2])
        ok = (svalid & ~torch.all(e == s[:, None, :], dim=-1)).contiguous()
        return (s.contiguous(), e.contiguous(), ok, pub.hits, pub.passes,
                config.map_min_passthrough, config.map_occu_threshold, thr_d2)

    for key, poses in (("b1", pose_q[None]), ("b4", inits)):
        args = k4_args(poses)
        s, e, ok = args[:3]
        got = raycarve.bad_ray_count(*args)
        want = raycast.bad_rays_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"bad_ray_count[{key}]: {got} vs {want}"
        n = (e - s[:, None, :]).abs().amax(-1).clamp(min=1)
        visited = int((n + 1)[ok].sum())
        bms, by = bound(visited * 8 + e.numel() * 4 + s.numel() * 4 + ok.numel()
                        + got.numel() * 4, visited * 20)
        entries[f"check_{key}"] = {
            "name": f"bad_ray_count[{key}]", "route": "cuda",
            "source": "roborts_slam_tpu_torch/ops/cuda/raycarve.cu",
            "replaces": "roborts_slam_tpu/ops/pallas/raycarve.py:164",
            "shape": [int(ok.shape[0]), int(ok.shape[1]), ps.height, ps.width],
            "launches": 0, "max_abs_err": float((got - want).abs().max()),
            "counts": got.tolist(),
            "ms": time_ms(lambda: raycarve.bad_ray_count(*args)),
            "plain_ms": time_ms(lambda: raycast.bad_rays_plain(*args), reps=20),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "cells_on_rays": visited,
        }
    # displaced poses, where many rays DO cross occupied cells
    args = k4_args(inits + torch.as_tensor([0.6, -0.4, 0.5], **f32))
    got, want = raycarve.bad_ray_count(*args), raycast.bad_rays_plain(*args)
    assert torch.equal(got, want) and int(got.sum()) > 0, (got, want)
    bad_displaced = got.tolist()

    # edge cases, kernel against plain version (not timed): rays that leave
    # the map on the low side (negative DDA numerators: the kernels' floor
    # division), a sensor outside the map, an empty scan, a pose far outside
    edge = {}
    corner = torch.as_tensor([-15.9, -15.8, 0.7], **f32)      # map cell (2, 4)
    outside = torch.as_tensor([-16.5, -17.0, 2.0], **f32)
    for name, pose in (("corner", corner), ("outside", outside)):
        st, en, bm = (t.contiguous() for t in raster._scan_cells(
            ps.inv_res, pub.offset, pts[q], msk[q], pose))
        got = raycarve.ray_mark_image(st, en, bm, ps.height, ps.width)
        want = raster.mark_image_plain(st, en, bm, ps.height, ps.width)
        assert torch.equal(got, want), f"ray_mark_image[{name}] differs"
        edge[f"carve_{name}_cells"] = int((got > 0).sum())
        assert int((en < 0).any()) == 1
    assert edge["carve_corner_cells"] > 0
    args = k4_args(torch.stack([corner, outside, pose_q]))
    got, want = raycarve.bad_ray_count(*args), raycast.bad_rays_plain(*args)
    assert torch.equal(got, want), (got, want)
    edge["check_counts"] = got.tolist()
    fs = fspec.fine_spec
    far = torch.as_tensor([500.0, -400.0, 0.1], **f32)
    for name, pose, n_valid in (("empty_scan", pose_q, 0), ("far_pose", far, nvs[q])):
        center = world_to_map_pose(state.fine.offset, fs.inv_res, pose)
        g = correlative.candidate_grid(fs, tiers["fine"], pts[q], n_valid, center)
        args = (state.fine.probs[None], g.rx[None].contiguous(), g.ry[None].contiguous(),
                g.svalid[None].contiguous(), g.xs[None].contiguous(),
                g.ys[None].contiguous(), float(fs.default_prob),
                torch.full((1,), g.divisor, **f32))
        got = correlation.correlation_scores(*args)
        want = correlative.correlation_scores_plain(*args)
        assert float((got - want).abs().max()) <= 1e-5 and bool(torch.isfinite(got).all())
        edge[f"score_{name}"] = float(got.mean())
        # every valid sample falls outside the map: default_prob each
        expect = fs.default_prob * int(g.svalid.sum()) / g.divisor
        assert abs(edge[f"score_{name}"] - expect) < 1e-5, (name, expect)
    assert edge["score_empty_scan"] == 0.0
    torch.cuda.synchronize()
    emit({"phase": "kernels_checked", "bad_counts_displaced": bad_displaced,
          "edge_cases": edge, "entries": len(entries)})
    del state, chain_maps, cp, cm, cpo
    torch.cuda.empty_cache()

    # ---- phase 4: the main path at full width ----
    # 70 scans out, then the same 70 in reverse order with times continuing
    # upward: an out-and-back run over identical poses
    order = list(range(n_scans)) + list(range(n_scans - 1, -1, -1))
    dt = float(times[1] - times[0])
    feed_times = [float(times[0]) + dt * k for k in range(len(order))]

    def reset_counts():
        correlation.launches = raycarve.mark_launches = raycarve.check_launches = 0

    def read_counts():
        return {"correlation_scores": correlation.launches,
                "ray_mark_image": raycarve.mark_launches,
                "bad_ray_count": raycarve.check_launches}

    def drive(cfg):
        """One out-and-back run through the public entry points; returns the
        engine, the kernels' launch counts of the run, and how many of them
        the back end's chain matches made."""
        chain = {"correlation_scores": 0, "bad_ray_count": 0}
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        eng = SlamEngine(cfg, laser, world_size=30.0)
        match_one = eng.backend._match_chain_batch_one

        def counted(*a, **kw):          # attributes launches to chain matches
            before = read_counts()
            out = match_one(*a, **kw)
            for name in chain:
                chain[name] += read_counts()[name] - before[name]
            return out

        eng.backend._match_chain_batch_one = counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, i in enumerate(order):
            eng.process(ranges[i], odom[i], feed_times[k])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        eng.force_graph_optimize()
        pub_map = eng.get_pub_map()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        kept = len(eng.store)
        traj = eng.trajectory_array()
        report = {
            "scans_fed": len(order), "kept": kept, "links": eng.backend.num_links,
            "loop_closures": eng.backend.num_loop_closures,
            "spa_solves": eng.backend.num_solves,
            "chain_dispatches": eng.backend.num_chain_dispatches,
            "launches": counts, "launches_in_chain_matches": dict(chain),
            "seconds": run_s, "loop_seconds": loop_s,
            "optimize_seconds": run_s - loop_s,
            "scans_per_s_fed": len(order) / loop_s, "scans_per_s_kept": kept / loop_s,
            "match_time_s": eng.diag.match_time_s,
            "backend_time_s": eng.diag.backend_time_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        assert kept >= 20, f"kept {kept} scans"
        assert eng.backend.num_links > 0 and eng.backend.num_solves >= 1
        assert all(v > 0 for v in counts.values()), counts
        assert np.isfinite(traj).all() and traj.shape == (kept, 4)
        assert (pub_map == 100).any() and (pub_map == 0).any()
        return eng, report, counts, chain

    from roborts_slam_tpu_torch.backend import spa
    # leg 1: the shipped profile unchanged. This short log never leaves the
    # 7 m link radius, so the graph proposes no chain match here.
    engine, report, front_counts, _ = drive(config)
    emit({"phase": "main_path", **report, "spa_host_syncs": spa.host_syncs})
    kept = len(engine.store)
    # leg 2: the same run with the link radius cut to 1 m, so that the back
    # end proposes near chains and loop candidates by itself: chain matches
    # (B chains a call, 2432² maps), loop verification, SPA, map rebuilds.
    engine2, report2, _, chain_counts = drive(
        config.replace(link_scan_max_distance=1.0))
    emit({"phase": "main_path_back_end", "link_scan_max_distance": 1.0, **report2})
    assert report2["chain_dispatches"] > 0, "no chain match was proposed"
    assert all(v > 0 for v in chain_counts.values()), chain_counts
    del engine2
    for e in entries.values():
        front = not e["name"].startswith(("correlation_scores[chain", "bad_ray_count[b4"))
        if e["name"].startswith("correlation_scores"):
            # every match launches each of the three tiers once
            total = front_counts["correlation_scores"] if front \
                else chain_counts["correlation_scores"]
            assert total % 3 == 0
            e["launches"] = total // 3
        elif e["name"] == "ray_mark_image":
            e["launches"] = front_counts["ray_mark_image"]
        else:
            e["launches"] = front_counts["bad_ray_count"] if front \
                else chain_counts["bad_ray_count"]
        e["launches_from"] = "main_path" if front else "main_path_back_end"
        assert e["launches"] > 0, f"{e['name']}: not launched on the main path"

    # where a kept scan's time can go: one SPA solve, one rebuild of all maps
    # after a correction, one B=4 chain match and the dilation inside it
    # (launch counts were read above; these repeats are not counted)
    last = kept - 1
    chains = [list(range(b, b + 10)) for b in range(0, 8, 2)]
    syncs0 = spa.host_syncs
    t1 = time.perf_counter()
    data = engine.backend.graph.as_solver_data(engine.store.poses_array(), dev)
    solved, _, lm_iters = spa.solve_pose_graph(data)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    solve_syncs = spa.host_syncs - syncs0
    t1 = time.perf_counter()
    engine._apply_corrections(engine.store.poses_array())
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t1
    chain_ms = time_ms(lambda: engine.backend._match_chain_batch(
        chains, last, engine.store.poses[last].copy()), reps=10, warm=2, inner=2)
    img = (torch.rand((4, bs.height, bs.width), device=dev) > 0.999).float()
    dilate_ms = time_ms(lambda: raster.dilate_with_kernel(img, bs.blur_kernel()),
                        reps=10, warm=2, inner=2)
    emit({"phase": "breakdown", "spa_solve_seconds": solve_s,
          "spa_lm_iterations": lm_iters, "spa_host_syncs_per_solve": solve_syncs,
          "graph_nodes": int(data.poses.shape[0]), "graph_edges": int(data.edge_ij.shape[0]),
          "rebuild_all_maps_seconds": rebuild_s, "rebuild_scans": kept,
          "chain_match_b4_ms": chain_ms, "dilate_b4_2432_ms": dilate_ms,
          "frontend_ms_per_scan": engine.diag.match_time_s / len(order) * 1e3})
    del img

    if "--profile" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--profile") + 1:]
        profile_frontend(SlamEngine, config, laser, ranges, odom, times,
                         rest[0] if rest else "out")

    # ---- phase 5: kernel path against plain path, end to end ----
    def replay(device, n):
        eng = SlamEngine(config, laser, world_size=30.0, device=device)
        kept_ids = [i for i in range(n)
                    if eng.process(ranges[i], odom[i], float(times[i]))]
        return kept_ids, eng.trajectory_array()

    before = correlation.launches
    ids_gpu, traj_gpu = replay(None, 20)
    assert correlation.launches > before
    ids_cpu, traj_cpu = replay("cpu", 20)
    assert ids_gpu == ids_cpu, (ids_gpu, ids_cpu)
    d = np.abs(traj_gpu - traj_cpu)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    emit({"phase": "kernel_vs_plain_path", "scans": 20, "kept": len(ids_gpu),
          "max_pos_diff_m": float(d[:, 1:3].max()),
          "max_ang_diff_rad": float(d[:, 3].max())})
    assert d[:, 1:3].max() <= POS_TOL and d[:, 3].max() <= ANG_TOL, d.max(0)

    emit({"kernels": list(entries.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
