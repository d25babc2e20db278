#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile [DIR]]

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card at the shapes of every main
path, drives the port's main paths at full width and shows that each launched
its kernels, at compared shapes only (the wrappers count launches by shape).
The two correlation kernels are also held bit for bit against each other,
against the plain version with the sums in their order and against a second
launch, and timed beside one ``torch.gather`` call in turns: ``ms`` per wrapper
call, ``device_us`` per launch, ``host_us`` per wrapper call, ``loses_by``.
The main paths:

- legs 1-2: the blocking per-scan SLAM loop under ``configs/simulation.yaml``
  (1152 points, 30 m world: a 3072² fine map, 2432² back-end chain maps) on
  the scans of ``tests/data/golden_willow.npz``, first correlation kernel;
- leg 3: ``python -m roborts_slam_tpu_torch run`` (called in-process) under
  ``configs/real_robot.yaml`` unchanged, with ``ROBORTS_CORR_KERNEL=2`` (the
  second correlation kernel), over a log simulated here from a seed: a
  closed corridor loop of 24 m x 16 m driven at 1 m/s with a 1081-beam 10 m
  lidar — sweep de-distortion, the rolling 15 m match-map window, chain
  matches and loop closures at the shipped 7 m link radius;
- leg 4: ``run`` with no ``--config`` (the default ``SlamConfig()``: the
  optimize matcher first) over the first 200 scans of that log, and two
  40-scan legs with the branch-and-bound coarse stage and with the windowed
  (running-range) match;
- leg 5: the online engine, ``run loop.rslg --config configs/real_robot.yaml
  --async --out-map ... --checkpoint ...`` (first correlation kernel): the log
  written as ``.rslg`` and read through the native decode worker, the back end
  on its worker thread, ``on_pose`` sampling the pose stream at 100 Hz of log
  time and ``on_map_snapshot`` every 50 kept scans.

Every engine runs the fused front-end+chain step, the default (the chain
batch of the chains predicted for a scan rides its step). Two phases hold
the JAX engine's other modes against leg 3, on its log and profile through
the API: ``fused_vs_unfused`` (``fused_backend=False``: same kept ids, links
and closures, within 1e-5, more separate chain batches) and
``pipelined_vs_blocking`` (``pipelined_fetch=True``, depth 3: same kept
count, links and closures, within 1e-4, identical pub maps, device store rows
equal to the host rows; the implicit synchronisations of every steady-state
dispatch counted with ``torch.cuda.set_sync_debug_mode`` and named by file
and line). More phases hold the online engine's other entry points against
leg 3's run: ``checkpoint_resume`` (half the log through the API, saved,
loaded into a new engine, the other half fed), its pipelined variant against
the pipelined run, and ``bag_vs_npz`` (the first 120 scans as a bz2-chunked
``.bag`` and as ``.npz`` through ``run``).

After leg 4, ``jax_full_width`` holds legs 1, 3 and 4 against the JAX
package's own results on the same inputs at full width
(``tests/data/jax_full_width.npz``, written on the CPU by
``scripts/torch_full_width_parity.py --write``; the logs are made again here
and only their SHA-256 is stored). Per leg it prints the kept counts and the
kept decisions that differ, the first parting scan, the link, closure and
solve counts, the trajectory gap on the scans both kept (max, median, count
over 2e-3 m), both ATEs against the simulated truth and the published-map
cells that differ. It fails the run if a log's hash differs, a closure count
differs, a kept count is more than 2 % from JAX's, or the port's ATE exceeds
max(1.25 x JAX's, JAX's + 5 mm).

``kernel_vs_plain_lockstep`` (after it) holds the card's steps one at a
time against the plain path: on leg 1's first 20 fed scans and leg 3's
first 60, the CPU plain engine's whole state is carried to the card before
each scan (``bench/lockstep.py``), both take the scan, and the card's step
is held at the per-step bars of ``bench/parity.py`` (pose 1e-5 m / 1e-5
rad, score 1e-5, positional covariance 1e-3 relative, the same decisions,
map cells but those a flipped beam names; at most three flips at a
discontinuity of the last bits, printed with their margins); every kernel
launch of the card's steps is held against its plain version on the same
inputs (correlation scores within 2.4e-7, carve cells and ray-check
counts equal); and the rounding helpers of ``ops/xla_rounding.py`` give
the same bits on the card as on the CPU.

Three phases run ``parallel/`` on leg 3's state: ``parallel_chain_match``
(eight of its chains against its newest scan through the sharded gather
matcher on a one-rank NCCL group and over two gloo ranks sharing the card,
against the unsharded call; the batched chain matcher with a centre per row
and the batched scan matcher), ``parallel_spa`` (the edge-sharded solve of
a 1024-node loop graph and of leg 3's pose graph, one NCCL rank at the full
budget and two gloo ranks at the scaling workload's, and the dense solve,
against the single solve) and ``log_odds`` (the log-odds map over leg 3's
kept scans, the carve kernel against the plain path on the CPU). One card
cannot show a multi-GPU number: these phases show the mechanics only.

The last phase, ``bench_headline``, is ``python -m roborts_slam_tpu_torch
bench`` (``bench/headline.py``): the two correlation kernels held against the
plain version at the headline's three tier shapes (a 2048² map), one match on
the card against the plain path on the CPU, then the benchmark with the first
and the second kernel in turns (1, 2, 2, 1) beside the CPU baseline: scans/s,
the time per match and its roofline against the card's published peaks, and
under ``--profile`` the device's launches per match and idle share.

Under each of the three configurations the first scans are also replayed on
the card and through the plain versions on the CPU, and must agree. Each
phase prints one JSON line; any failed phase raises and the process exits
non-zero. It needs one CUDA device and never falls back to the CPU.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.bench.parity import (
    LOOP_LAPS, LOOP_SEED, corridor_loop_log, corridor_loop_path,
)
from roborts_slam_tpu_torch.bench.roofline import bound, tier_cost
from roborts_slam_tpu_torch.bench.timing import device_us, host_us, in_turns, time_ms

ROOT = Path(__file__).resolve().parent
POS_TOL, ANG_TOL = 2e-3, 2e-3  # trajectory agreement bar (m, rad)
ATE_BAR_M = 0.3           # leg 3's bar on the ATE against the simulated truth
STREAM_DT = 0.01          # leg 5 samples the pose stream at 100 Hz of log time
SNAPSHOT_EVERY = 50       # leg 5's map snapshot hook: every 50 kept scans
# offsets of the start poses of a batch of matches (a chain batch holds at most 8)
NUDGE = [[0, 0, 0], [0.02, 0, 0], [0, 0.02, 0], [0, 0, 0.01],
         [-0.02, 0, 0], [0, -0.02, 0], [0, 0, -0.01], [0.02, 0.02, 0]]
# What this script read of the carve and ray-check kernels before their
# redesign (a warp per beam behind torch's fill with two 64-bit divisions a
# visit; a warp per ray in rounds of 32 steps with a vote after each, behind a
# zeroed count), on an NVIDIA H100 80GB HBM3 at 700.00 W. device_us: output
# zeroed and walk in one graph; walk_device_us: the walk alone. Printed beside
# this run's figures, never mixed with them.
EARLIER_RAY_KERNELS = {
    "ray_mark_image[pub_640x640]": {"ms": 0.0496, "device_us": 5.22, "walk_device_us": 3.74,
                                    "host_us": 45.61, "bare_host_us": 8.18},
    "ray_mark_image[rr_pub_1024x1024]": {"ms": 0.0290, "device_us": 5.83, "walk_device_us": 3.53,
                                         "host_us": 47.10, "bare_host_us": 5.83},
    "ray_mark_image[default_pub_896x896]": {"ms": 0.0310, "device_us": 5.48,
                                            "walk_device_us": 3.59, "host_us": 30.65,
                                            "bare_host_us": 5.17},
    "bad_ray_count[pub_640x640_b1]": {"ms": 0.0600, "device_us": 7.22, "walk_device_us": 6.27,
                                      "host_us": 55.17, "bare_host_us": 12.21},
    "bad_ray_count[rr_pub_1024x1024_b1]": {"ms": 0.0535, "device_us": 7.24,
                                           "walk_device_us": 6.28, "host_us": 51.02,
                                           "bare_host_us": 11.15},
    "bad_ray_count[default_pub_896x896_b1]": {"ms": 0.0343, "device_us": 7.15,
                                              "walk_device_us": 6.23, "host_us": 36.08,
                                              "bare_host_us": 8.34},
}


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it ended (``at_s``,
    seconds since the script started)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def patched(owner, name, wrapper_of):
    """Replace ``owner.name`` by ``wrapper_of(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, wrapper_of(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def corr_kernel(version: int):
    """``ROBORTS_CORR_KERNEL`` set to ``version`` inside the block."""
    before = os.environ.get("ROBORTS_CORR_KERNEL")
    os.environ["ROBORTS_CORR_KERNEL"] = str(version)
    try:
        yield
    finally:
        if before is None:
            del os.environ["ROBORTS_CORR_KERNEL"]
        else:
            os.environ["ROBORTS_CORR_KERNEL"] = before


def profile_frontend(SlamEngine, config, laser, ranges, odom, times, world_size,
                     out_dir, tag, n=30, synchronous_backend=True, pipelined=False):
    """Optional (``--profile [DIR]``): trace the per-scan loop over the first
    scans with torch.profiler, print the device-busy share and the heaviest
    device kernels, and write the table to ``DIR/profile_<tag>.txt`` (default
    ``out/``). With ``synchronous_backend=False`` the back end runs on its
    worker thread, which is joined (``finish``) inside the traced window;
    ``pipelined``: the pipelined fetch, drained (``finish``) inside it."""
    from torch.profiler import ProfilerActivity, profile

    def new_engine():
        eng = SlamEngine(config, laser, world_size=world_size,
                         synchronous_backend=synchronous_backend)
        eng.pipelined_fetch = pipelined
        for i in range(5):
            eng.process(ranges[i], odom[i], float(times[i]))
        eng.finish()
        torch.cuda.synchronize()
        return eng

    engine = new_engine()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5, n):
            engine.process(ranges[i], odom[i], float(times[i]))
        engine.finish()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dt = device_time(prof, out_dir, tag)
    # the profiler slows the host side several times over, so the share is
    # also given against the unprofiled per-scan wall time of the same scans
    engine2 = new_engine()
    t0 = time.perf_counter()
    for i in range(5, n):
        engine2.process(ranges[i], odom[i], float(times[i]))
    engine2.finish()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    emit({"phase": "profile", "configuration": tag, "scans": n - 5,
          "synchronous_backend": synchronous_backend, "pipelined_fetch": pipelined,
          "fused_steps": engine2.diag.fused_steps,
          "backend_seconds": engine2.diag.backend_time_s,
          "backend_batch_max": engine2.diag.backend_batch_max,
          "profiled_wall_seconds": wall,
          "unprofiled_wall_seconds": plain_wall, **idle_shares(dt, plain_wall)})


def device_time(prof, out_dir, tag):
    """What a torch.profiler trace says of the device: the busy seconds
    summed over kernel rows, the union of the device intervals, the
    launches and the heaviest kernels. Writes the table to
    ``out_dir/profile_<tag>.txt``."""
    avg = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    # device rows only: an operator row repeats the time of the kernels it
    # launched, so summing every row would count the device twice
    kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(kernels, key=dev_time, reverse=True)
    # the same from the trace's device intervals: the time during which at
    # least one kernel, copy or fill ran, an interval recorded twice (or two
    # that overlap) counted once
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            spans.append((start, start + e.duration_ns() if hasattr(e, "duration_ns")
                          else start + e.duration_us() * 1000, e.name()))
    union_ns, end = 0, -1
    for a, b, _ in sorted(spans):
        if b > end:
            union_ns += b - max(a, end)
            end = b
    out = ROOT / out_dir
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{tag}.txt").write_text(avg.table(
        sort_by="self_cuda_time_total", row_limit=60, max_name_column_width=80))
    return {"busy_s": sum(dev_time(e) for e in kernels) * 1e-6,
            "launches": sum(e.count for e in kernels),
            "intervals": len(spans), "intervals_distinct": len(set(spans)),
            "union_s": union_ns * 1e-9,
            "top": [{"name": e.key[:70], "calls": e.count, "device_ms": dev_time(e) * 1e-3}
                    for e in rows[:12] if dev_time(e) > 0]}


def idle_shares(dt, plain_wall):
    """``device_time``'s figures against the unprofiled wall time of the
    same work (the profiler slows the host several times over)."""
    return {"device_busy_seconds": dt["busy_s"],
            "device_launches": dt["launches"],
            "device_busy_share_of_unprofiled_wall": dt["busy_s"] / plain_wall,
            "device_idle_share_of_unprofiled_wall": 1.0 - dt["busy_s"] / plain_wall,
            "device_intervals": dt["intervals"],
            "device_intervals_distinct": dt["intervals_distinct"],
            "device_union_busy_seconds": dt["union_s"],
            "device_union_idle_share_of_unprofiled_wall": 1.0 - dt["union_s"] / plain_wall,
            "top_device_kernels": dt["top"]}


def profile_matches(f, n, out_dir, tag):
    """Optional (``--profile [DIR]``): ``f(0, n)``, a chain of ``n`` headline
    matches, traced with torch.profiler; the device's launches per match and
    its idle share against the unprofiled wall of the same chain."""
    from torch.profiler import ProfilerActivity, profile

    f(0, n).cpu()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        f(0, n).cpu()
    wall = time.perf_counter() - t0
    dt = device_time(prof, out_dir, tag)
    t0 = time.perf_counter()
    f(0, n).cpu()
    plain_wall = time.perf_counter() - t0
    return {"matches": n, "profiled_wall_seconds": wall,
            "unprofiled_wall_seconds": plain_wall,
            "device_launches_per_match": dt["launches"] / n,
            **idle_shares(dt, plain_wall)}


def profile_dir():
    """``--profile [DIR]``: the directory profiles go to (default ``out``);
    ``None`` without ``--profile``."""
    if "--profile" not in sys.argv[1:]:
        return None
    rest = sys.argv[sys.argv.index("--profile") + 1:]
    return rest[0] if rest else "out"


def parallel_rank(spec, operands, graphs, budget, device):
    """One rank of the two-rank run of ``parallel_chain_match`` and
    ``parallel_spa`` (gloo, both ranks on card 0, started by
    ``multihost.launch_local``): the sharded gather matcher on this rank's
    half of the chains, then each graph solved with its edges sharded over
    both ranks at ``budget`` (LM, CG iterations), on ``device``."""
    from roborts_slam_tpu_torch.backend import spa
    from roborts_slam_tpu_torch.parallel.dist_spa import solve_pose_graph_sharded
    from roborts_slam_tpu_torch.parallel.mesh import make_mesh
    from roborts_slam_tpu_torch.parallel.sharded_match import (
        make_sharded_chain_matcher_gather,
    )

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    ops = tuple(o.to(dev) if isinstance(o, torch.Tensor) else o for o in operands)
    mesh = make_mesh(axis_name="data", device=dev)
    sync()
    t0 = time.perf_counter()
    rows = make_sharded_chain_matcher_gather(spec, mesh)(*ops)
    sync()
    out = {"gather": rows, "gather_s": time.perf_counter() - t0,
           "gather_all_reduces": mesh.all_reduces, "spa": []}
    gmesh = make_mesh(axis_name="graph", device=dev)
    for data in graphs:
        syncs, reduces = spa.host_syncs, gmesh.all_reduces
        sync()
        t0 = time.perf_counter()
        poses, cost, iters = solve_pose_graph_sharded(data, gmesh, "graph", *budget)
        sync()
        out["spa"].append({"poses": poses, "cost": cost, "iters": iters,
                           "seconds": time.perf_counter() - t0,
                           "host_syncs": spa.host_syncs - syncs,
                           "all_reduces": gmesh.all_reduces - reduces})
    return out


def parallel_phases(eng3, rr_config, rr_fspec, rr_bspec, dev, acct, backend=None):
    """``parallel/`` on leg 3's final state (``eng3``), first correlation
    kernel: the phases ``parallel_chain_match``, ``parallel_spa`` and
    ``log_odds``. The card is one: a one-rank group in this process
    (``backend`` None: NCCL), and two gloo ranks that share the device (NCCL
    refuses two ranks on one device), started as processes; no multi-GPU
    number can come from it. ``acct`` carries the launch accounting of
    ``main`` (``reset_counts``, ``read_counts``, ``read_shapes``,
    ``shapes_said``, ``account``, ``relist`` and the real-robot context
    ``ctx``); every launch of a phase, in this process or in a rank, is
    counted by shape and held against the plain versions."""
    import torch.distributed as dist

    from roborts_slam_tpu_torch.backend import spa
    from roborts_slam_tpu_torch.backend.processor import chain_match_batch_gather
    from roborts_slam_tpu_torch.models.grid_map import (
        log_odds_map_states, make_log_odds_map,
    )
    from roborts_slam_tpu_torch.ops.raster import update_log_odds_map
    from roborts_slam_tpu_torch.parallel import multihost
    from roborts_slam_tpu_torch.parallel.dist_spa import solve_pose_graph_sharded
    from roborts_slam_tpu_torch.parallel.mesh import make_mesh
    from roborts_slam_tpu_torch.parallel.sharded_match import (
        make_batched_chain_matcher, make_batched_scan_matcher,
        make_sharded_chain_matcher_gather,
    )

    f32 = dict(dtype=torch.float32, device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    PAR, PSPA, LOGODDS = "parallel_chain_match", "parallel_spa", "log_odds"
    B_PAR = 8
    on_cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    n3 = len(eng3.store)
    dpts3, dmsk3, dposes3 = (t[:n3] for t in eng3.store.device_arrays())
    newest = n3 - 1
    newest_pose = dposes3[newest]
    # eight chains of up to 16 consecutive kept scans (max_chain_scans) whose
    # scans lie within the link radius of the newest scan, nearest first
    K = rr_config.max_chain_scans
    xy = eng3.store.poses_array()[:, :2]
    dist_m = np.linalg.norm(xy - xy[newest], axis=1)
    for radius in (rr_config.link_scan_max_distance, 2 * rr_config.link_scan_max_distance,
                   np.inf):
        near = [i for i in range(newest) if dist_m[i] <= radius]
        runs, run = [], []
        for i in near:
            if run and (i != run[-1] + 1 or len(run) == K):
                runs.append(run)
                run = []
            run.append(i)
        runs.append(run)
        runs = [r for r in runs if r]
        if len(runs) >= B_PAR:
            break
    runs = sorted(runs, key=lambda r: float(dist_m[r].mean()))[:B_PAR]
    assert len(runs) == B_PAR, f"{len(runs)} chains in the store"
    chain_ids = torch.full((B_PAR, K), -1, dtype=torch.int64, device=dev)
    for b, r in enumerate(runs):
        chain_ids[b, :len(r)] = torch.as_tensor(r, device=dev)
    inits = newest_pose[None] + torch.as_tensor(NUDGE[:B_PAR], **f32)
    pub_spec3, hits3, passes3, pub_off3 = eng3.store.pub_map_arrays()
    gather_ops = (dpts3, dmsk3, dposes3, chain_ids, newest, eng3.store.n_valid(newest),
                  inits, newest_pose, hits3, passes3, pub_off3)
    graph_1024 = multihost.make_synthetic_loop_graph(1024, device=dev)
    # leg 3's pose graph. Its final poses are this graph's optimum (the
    # closure's solve corrected them): solved from there, every LM step sits
    # in the flat valley where a change in the order of the float sums flips
    # accept/reject decisions, and two single solves part by up to ~1.5e-3 m
    # (printed as ``converged_start_two_single_solves``). The sharded solves
    # start from those poses perturbed (seed 0; node 0 kept), off the optimum
    # as a closure's solve starts
    graph_leg3_opt = eng3.backend.graph.as_solver_data(eng3.store.poses_array(), dev)
    start_noise = np.random.default_rng(0).normal(0, [0.05, 0.05, 0.01], (n3, 3))
    start_noise[0] = 0
    graph_leg3 = graph_leg3_opt._replace(
        poses=graph_leg3_opt.poses + torch.as_tensor(start_noise, **f32))
    budget_full, budget_scaling = (50, 100), (10, 25)     # spa_scaling_workload's
    acct.relist(PAR, ("corr", "check"), lambda key: True)
    acct.relist(LOGODDS, ("mark",), lambda key: True)

    # the two gloo ranks first: their chain matches and sharded solves
    acct.reset_counts()
    t1 = time.perf_counter()
    two = multihost.launch_local(
        "chip_smoke:parallel_rank", 2,
        args=(rr_bspec, tuple(on_cpu(t) for t in gather_ops),
              [g._replace(**{k: on_cpu(v) for k, v in g._asdict().items()})
               for g in (graph_1024, graph_leg3)], budget_scaling, str(dev)),
        backend="gloo", timeout=400)
    two_s = time.perf_counter() - t1
    # this process: a one-rank NCCL group on the card
    multihost.initialize_distributed(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend)
    mesh1 = make_mesh(axis_name="data", device=dev)
    gmesh1 = make_mesh(axis_name="graph", device=dev)
    warm = torch.ones(3, **f32)
    gmesh1.all_reduce(warm, "graph")            # the communicator is made here
    gmesh1.all_reduces = 0
    sync()

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    single, single_s = timed(lambda: chain_match_batch_gather(rr_bspec, *gather_ops))
    one, one_s = timed(lambda: make_sharded_chain_matcher_gather(rr_bspec, mesh1)(*gather_ops))
    gather_reduces = mesh1.all_reduces
    # per-row centres: row b's chain around init b, the newest scan
    chain_rows = (dpts3[chain_ids.clamp(min=0)],
                  dmsk3[chain_ids.clamp(min=0)] & (chain_ids >= 0)[..., None],
                  dposes3[chain_ids.clamp(min=0)], chain_ids >= 0,
                  dpts3[newest][None].expand(B_PAR, -1, -1),
                  dmsk3[newest][None].expand(B_PAR, -1),
                  torch.full((B_PAR,), eng3.store.n_valid(newest)), inits, inits)
    chain_args = (rr_bspec.coarse_spec, rr_bspec.fine_spec, rr_bspec.matcher,
                  rr_config.coarse_map_use_blur, rr_config.fine_map_use_blur)
    rows_none, rows_none_s = timed(lambda: make_batched_chain_matcher(*chain_args)(*chain_rows))
    rows_one = make_batched_chain_matcher(*chain_args, mesh=mesh1)(*chain_rows)
    # eight of leg 3's newest kept scans against its fine map, from their poses
    # nudged
    last8 = torch.arange(n3 - B_PAR, n3, device=dev)
    scan_ops = (eng3.state.fine.probs, eng3.state.fine.offset, eng3.state.coarse.probs,
                eng3.state.coarse.offset, dpts3[last8], dmsk3[last8],
                torch.as_tensor([eng3.store.n_valid(int(i)) for i in last8]),
                dposes3[last8] + torch.as_tensor(NUDGE[:B_PAR], **f32))
    scan_args = (rr_fspec.fine_spec, rr_fspec.coarse_spec, rr_fspec.matcher)
    scans_none, scans_none_s = timed(lambda: make_batched_scan_matcher(*scan_args)(*scan_ops))
    scans_one = make_batched_scan_matcher(*scan_args, mesh=mesh1)(*scan_ops)
    sync()
    shapes_par = acct.read_shapes()
    # the ranks' launches join this process's
    for r in two:
        for kind, by in r.launch_shapes.items():
            for k, v in by.items():
                shapes_par[kind][k] = shapes_par[kind].get(k, 0) + v
    # the same functions through the plain versions on the CPU
    rows_cpu = make_batched_chain_matcher(*chain_args)(*(on_cpu(t) for t in chain_rows))
    scans_cpu = make_batched_scan_matcher(*scan_args)(*(on_cpu(t) for t in scan_ops))

    def diffs(got, want):
        return {"pose": pose_diff(got[0].cpu(), want[0].cpu()),
                "score": float((got[1].cpu() - want[1].cpu()).abs().max()),
                "cov_xy_rel": float(((got[2][:, :2, :2].cpu() - want[2][:, :2, :2].cpu()).abs()
                                     / want[2][:, :2, :2].cpu().abs().clamp(min=1e-9)).max()),
                "bit_equal": all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))}

    gather_two = [r.result["gather"] for r in two]
    par = {
        "chains": [len(r) for r in runs], "chain_first_ids": [r[0] for r in runs],
        "scan_id": newest, "max_chain_scans": K,
        "gather_unsharded_s": single_s, "gather_one_rank_nccl_s": one_s,
        "gather_one_rank_all_reduces": gather_reduces,
        "gather_two_rank_gloo_s": [r.result["gather_s"] for r in two],
        "gather_two_rank_all_reduces": [r.result["gather_all_reduces"] for r in two],
        "two_rank_launch_s": two_s, "two_rank_seconds": [r.seconds for r in two],
        "two_ranks_bit_equal": all(torch.equal(a, b) for a, b in zip(*gather_two)),
        "one_rank_vs_unsharded": diffs(one, single),
        "two_rank_vs_unsharded": diffs(gather_two[0], single),
        "scores": single[1].tolist(),
        "batched_chain_rows_s": rows_none_s,
        "batched_chain_one_rank_vs_none": diffs(rows_one, rows_none),
        "batched_chain_card_vs_cpu_plain": diffs(rows_none, rows_cpu),
        "batched_chain_scores": rows_none[1].tolist(),
        "batched_scan_s": scans_none_s,
        "batched_scan_one_rank_vs_none": diffs(scans_one, scans_none),
        "batched_scan_card_vs_cpu_plain": diffs(scans_none, scans_cpu),
        "batched_scan_scores": scans_none[1].tolist(),
        "launches_by_shape": acct.shapes_said(shapes_par),
        "launches_by_shape_in_ranks": [acct.shapes_said(r.launch_shapes) for r in two]}
    emit({"phase": PAR, "corr_kernel": 1, "chain_batch": B_PAR, **par})
    assert par["two_ranks_bit_equal"], "the two ranks gathered other rows"
    for key in ("one_rank_vs_unsharded", "two_rank_vs_unsharded"):
        assert par[key]["pose"] <= 5e-6 and par[key]["score"] <= 2e-5, (key, par[key])
    for key in ("batched_chain_one_rank_vs_none", "batched_scan_one_rank_vs_none"):
        assert par[key]["bit_equal"], key
    for key in ("batched_chain_card_vs_cpu_plain", "batched_scan_card_vs_cpu_plain"):
        assert par[key]["pose"] <= POS_TOL, (key, par[key])
    for got in (single, rows_none, scans_none):
        assert all(bool(torch.isfinite(t).all()) for t in got)
        assert bool(((got[1] >= 0) & (got[1] <= 1)).all()), got[1]
    assert gather_reduces == 1 and all(r.result["gather_all_reduces"] == 1 for r in two)
    # every launch of the phase, counted by shape: three tiers per chain batch
    # (B=8 twice here, B=4 once in each rank) and per row of the batched
    # matchers (twice each here), one ray check per chain batch
    corr_by_b = Counter()
    for k, v in shapes_par["corr"].items():
        assert k[0] == 1, f"{PAR}: second kernel launched"
        corr_by_b[k[1], k[5:]] += v
    chain_hw = (rr_bspec.fine_spec.height, rr_bspec.fine_spec.width)
    front_hw = (rr_fspec.fine_spec.height, rr_fspec.fine_spec.width)
    assert corr_by_b == {(8, chain_hw): 6, (4, chain_hw): 6,
                         (1, chain_hw): 2 * 3 * B_PAR, (1, front_hw): 2 * 3 * B_PAR}, corr_by_b
    assert sorted((k[0], v) for k, v in shapes_par["check"].items()) == [(4, 2), (8, 2)], \
        shapes_par["check"]
    assert not shapes_par["mark"], shapes_par["mark"]
    acct.account(PAR, shapes_par, acct.ctx)

    @contextlib.contextmanager
    def deterministic():
        """``torch.use_deterministic_algorithms`` inside the block: the
        card's ``index_add_`` then sums in a fixed order (warnings for ops
        that have no such mode, the cuBLAS products, silenced)."""
        before = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*deterministic.*")
                yield
        finally:
            torch.use_deterministic_algorithms(before[0], warn_only=before[1])

    def compared(got, ref):
        (gp, gc), (rp, rc) = got, ref
        return {"max_pose_diff": pose_diff(gp.cpu(), rp.cpu()),
                "cost_diff": abs(float(gc) - float(rc)),
                "bit_equal": torch.equal(gp, rp.to(gp.device)) and torch.equal(gc, rc.to(gc.device))}

    def within_bars(d, ref_cost):
        """The bars of tests/test_parallel.py:22-24: cost within 1e-3
        relative (the exact loop graph's optimum is near 0: 1e-6 absolute
        there), poses within 1e-3."""
        return d["cost_diff"] <= 1e-3 * abs(float(ref_cost)) + 1e-6 and d["max_pose_diff"] <= 1e-3

    # the solves: one NCCL rank at the full budget, two gloo ranks at the
    # scaling workload's, each against the single solve at the same budget.
    # The card's segment sums (index_add_) add in atomic order, so two solves
    # of one graph part in the last bits, and 50 LM iterations in a flat
    # valley carry that to ~1e-3: the full-budget single solve runs under
    # deterministic algorithms, the one-rank solve once so (the same sums:
    # bit for bit) and once in the default mode, whose distance is reported
    # beside the cost bar
    spa_said = {}
    for gi, (gname, g) in enumerate((("loop_1024", graph_1024), ("leg3", graph_leg3))):
        said = {"nodes": int(g.poses.shape[0]), "edges": int(g.edge_ij.shape[0])}
        refs = {}
        syncs = spa.host_syncs
        (p, c, it), sec = timed(lambda: spa.solve_pose_graph(g, *budget_scaling))
        said["single_scaling"] = {"seconds": sec, "iters": it, "cost": float(c),
                                  "host_syncs": spa.host_syncs - syncs}
        refs["scaling"] = (p, c)
        syncs, reduces = spa.host_syncs, gmesh1.all_reduces
        (p1, c1, it1), sec = timed(lambda: solve_pose_graph_sharded(g, gmesh1, "graph",
                                                                    *budget_full))
        one_said = {"seconds": sec, "iters": it1, "cost": float(c1),
               "host_syncs": spa.host_syncs - syncs, "all_reduces": gmesh1.all_reduces - reduces}
        with deterministic():
            syncs = spa.host_syncs
            (pd_, cd_, itd), sec = timed(lambda: spa.solve_pose_graph(g, *budget_full))
            said["single_full_deterministic"] = {"seconds": sec, "iters": itd, "cost": float(cd_),
                                                 "host_syncs": spa.host_syncs - syncs}
            (pd1, cd1, _), sec_one = timed(lambda: solve_pose_graph_sharded(
                g, gmesh1, "graph", *budget_full))
        refs["full"] = (pd_, cd_)
        one_said.update(compared((p1, c1), refs["full"]))
        assert one_said["cost_diff"] <= 1e-3 * abs(float(cd_)) + 1e-6, (gname, one_said)
        one_said["deterministic"] = {"seconds": sec_one, **compared((pd1, cd1), refs["full"])}
        assert within_bars(one_said["deterministic"], cd_), (gname, one_said)
        said["one_rank_nccl_full"] = one_said
        ranks = [r.result["spa"][gi] for r in two]
        said["two_rank_gloo_scaling"] = {
            "seconds": [r["seconds"] for r in ranks], "iters": [r["iters"] for r in ranks],
            "cost": float(ranks[0]["cost"]), "host_syncs": [r["host_syncs"] for r in ranks],
            "all_reduces": [r["all_reduces"] for r in ranks],
            "ranks_bit_equal": torch.equal(ranks[0]["poses"], ranks[1]["poses"])
            and torch.equal(ranks[0]["cost"], ranks[1]["cost"])
            and ranks[0]["iters"] == ranks[1]["iters"],
            **compared((ranks[0]["poses"], ranks[0]["cost"]), refs["scaling"])}
        assert within_bars(said["two_rank_gloo_scaling"], refs["scaling"][1]), \
            (gname, said["two_rank_gloo_scaling"])
        assert said["two_rank_gloo_scaling"]["ranks_bit_equal"], gname
        if gname == "leg3":
            conv = [spa.solve_pose_graph(graph_leg3_opt, *budget_scaling) for _ in range(2)]
            said["converged_start_two_single_solves"] = compared(conv[0][:2], conv[1][:2])
            # the dense solve against the PCG solve of the same start: from
            # the converged start (asserted), and from the perturbed one,
            # where 50 LM / 100 CG iterations leave PCG short of the optimum
            # that the dense solve reaches (printed only)
            (pc, cc, _), _ = timed(lambda: spa.solve_pose_graph(graph_leg3_opt, *budget_full))
            for key, start, (rp, rc) in (("dense", graph_leg3_opt, (pc, cc)),
                                         ("dense_from_perturbed", g, refs["full"])):
                syncs = spa.host_syncs
                (pd, cd), sec = timed(lambda: spa.solve_pose_graph_dense(start))
                said[key] = {"seconds": sec, "host_syncs": spa.host_syncs - syncs,
                             "cost": float(cd), "pcg_cost": float(rc),
                             "max_pose_diff": pose_diff(pd.cpu(), rp.cpu()),
                             "cost_rel_diff": abs(float(cd) - float(rc)) / abs(float(rc))}
                said[key]["within_1e-3"] = (said[key]["cost_rel_diff"] <= 1e-3
                                            and said[key]["max_pose_diff"] <= 1e-3)
            # another algorithm than the PCG solve: the JAX package's bar for
            # dense against PCG (tests/test_spa.py:85-91), 5 % and 0.05 m
            assert said["dense"]["cost_rel_diff"] < 0.05 and \
                said["dense"]["max_pose_diff"] < 0.05, said["dense"]
        spa_said[gname] = said
    emit({"phase": PSPA, "budgets": {"full": list(budget_full), "scaling": list(budget_scaling)},
          **spa_said})
    dist.destroy_process_group()
    del mesh1, gmesh1

    # the log-odds map over leg 3's kept scans at their final poses, on the
    # card (the carve kernel) and through the plain path on the CPU
    acct.reset_counts()
    maps = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        lmap = make_log_odds_map(pub_spec3, pub_off3.to(d), d)
        pts_, msk_, poses_ = dpts3.to(d), dmsk3.to(d), dposes3.to(d)
        sync()
        t = time.perf_counter()
        for i in range(n3):
            update_log_odds_map(pub_spec3, lmap, pts_[i], msk_[i], poses_[i])
        sync()
        maps[where] = (lmap, time.perf_counter() - t)
        if where == "card":
            shapes_lo = acct.read_shapes()
    st_card = log_odds_map_states(maps["card"][0]).cpu()
    st_cpu = log_odds_map_states(maps["cpu"][0])
    lo = {"scans": n3, "pub_map": [pub_spec3.height, pub_spec3.width],
          "card_s": maps["card"][1], "cpu_plain_s": maps["cpu"][1],
          "states_differing": int((st_card != st_cpu).sum()),
          "log_odds_max_abs_diff": float((maps["card"][0].log_odds.cpu()
                                          - maps["cpu"][0].log_odds).abs().max()),
          "cells": {str(v): int((st_card == v).sum()) for v in (-1, 0, 100)},
          "launches": acct.read_counts(), "launches_by_shape": acct.shapes_said(shapes_lo)}
    emit({"phase": LOGODDS, **lo})
    assert lo["states_differing"] == 0, "log-odds states differ"
    assert lo["cells"]["100"] > 0 and lo["cells"]["0"] > 0
    assert sum(shapes_lo["mark"].values()) == n3 and not shapes_lo["corr"] \
        and not shapes_lo["check"], shapes_lo
    acct.account(LOGODDS, shapes_lo, acct.ctx)
    del maps, st_card, st_cpu, dpts3, dmsk3, dposes3, graph_1024, graph_leg3, graph_leg3_opt, two
    del single, one, rows_none, rows_one, scans_none, scans_one, chain_rows, scan_ops
    del gather_ops, hits3, passes3


@contextlib.contextmanager
def kernels_held_to_plain():
    """Inside the block every launch of the four kernels' wrappers on card
    tensors is held against its plain version on the same inputs (run on
    the card, not counted as a launch): the largest |scores - plain| of the
    correlation kernels, the carve's differing cells and the ray check's
    differing counts, in the yielded dict."""
    from roborts_slam_tpu_torch.ops import correlative, raster, raycast
    from roborts_slam_tpu_torch.ops.cuda import correlation

    seen = {"correlation_max_abs_diff": 0.0, "carve_cells_differing": 0,
            "check_counts_differing": 0, "held": Counter()}

    def corr(orig):
        def run(probs, rx, ry, svalid, xs, ys, default_prob, divisor):
            out = orig(probs, rx, ry, svalid, xs, ys, default_prob, divisor)
            if probs.is_cuda:
                want = correlative.correlation_scores_plain(probs, rx, ry, svalid, xs, ys,
                                                            default_prob, divisor)
                seen["correlation_max_abs_diff"] = max(seen["correlation_max_abs_diff"],
                                                       float((out - want).abs().max()))
                seen["held"][orig.__name__] += 1
            return out
        return run

    def mark(orig):
        def run(start, end, beam_mask, height, width):
            out = orig(start, end, beam_mask, height, width)
            if start.is_cuda:
                want = raster.mark_image_plain(start, end, beam_mask, height, width)
                seen["carve_cells_differing"] += int((out != want).sum())
                seen["held"]["ray_mark_image"] += 1
            return out
        return run

    def check(orig):
        def run(*args):
            out = orig(*args)
            if args[0].is_cuda:
                seen["check_counts_differing"] += int((out != raycast.bad_rays_plain(*args)).sum())
                seen["held"]["bad_ray_count"] += 1
            return out
        return run

    with patched(correlation, "correlation_scores", corr), \
            patched(correlation, "correlation_scores_v2", corr), \
            patched(raster, "ray_mark_image", mark), patched(raycast, "bad_ray_count", check):
        yield seen


def rounding_helpers_card_vs_cpu(dev) -> dict:
    """The three roundings of the JAX package's compiled step that the port
    mirrors (``ops/xla_rounding.py``) on seeded inputs on the card and on
    the CPU: the number of results whose bits differ (0 expected: the
    helpers are float64 operations and sequential folds, the same bits on
    both devices)."""
    from roborts_slam_tpu_torch.ops import xla_rounding as X

    g = torch.Generator().manual_seed(3)
    a, b, c = (torch.randn(1 << 16, generator=g) * 100 for _ in range(3))
    def ties(A, N):       # 256 grids with 1-6 tied candidates each, and the values
        w = torch.zeros(256, A * N * N).scatter_(
            1, torch.randint(0, A * N * N, (256, X.TIE_SLOTS), generator=g), 0.9)
        w *= torch.rand(256, A * N * N, generator=g) > 0.3
        w += torch.rand(256, A * N * N, generator=g) * 0.01 * (w > 0)
        return (w.view(256, A, N, N), torch.rand(256, N, generator=g) * 600,
                torch.rand(256, N, generator=g) * 600, torch.rand(256, A, generator=g) * 2 - 1,
                torch.rand(256, A, generator=g) * 2 - 1)

    coarse, fine = ties(101, 9), ties(21, 11)
    runs = {
        "fma_f32": lambda d: X.fma_f32(a.to(d), b.to(d), c.to(d)),
        "map_to_world_xy": lambda d: X.map_to_world_xy(c[:2].to(d), 40.0, (a * 40).to(d)[:, None]
                                                       .expand(-1, 2).contiguous()),
        "angle_ramp": lambda d: X.angle_ramp(a[:4096, None].to(d), 101, 0.00349),
        "candidate_offsets": lambda d: X.candidate_offsets(
            torch.stack([a, b], -1)[:4096].abs().to(d), 40.0, 4.0, 11, 0.8),
        "tie_sums_windowed": lambda d: X.tie_sums(*(t.to(d) for t in coarse)),
        "tie_sums_fused": lambda d: X.tie_sums(*(t.to(d) for t in fine))}
    return {k: int((f(dev).cpu() != f("cpu")).sum()) for k, f in runs.items()}


def lockstep_phase(SlamEngine, dev, legs) -> dict:
    """``kernel_vs_plain_lockstep``: per leg (tag, config, laser, world
    size, correlation kernel, feed) the port's plain path on the CPU as the
    reference, carried to the card before each scan
    (``bench/lockstep.py``), every kernel launch of the card's steps held
    against its plain version; fails where a step misses the per-step bars
    beyond three flips, a correlation kernel is more than 2.4e-7 from the
    plain version, the carve differs in a cell, the ray check in a count,
    or a rounding helper in a bit between the card and the CPU."""
    from roborts_slam_tpu_torch.bench import lockstep

    out, t_all = {"legs": {}}, time.perf_counter()
    for tag, cfg, scan_laser, world_size, version, feed in legs:
        ref = SlamEngine(cfg, scan_laser, world_size=world_size, device="cpu")
        t0 = time.perf_counter()
        with corr_kernel(version), kernels_held_to_plain() as held:
            rep = lockstep.lockstep(ref, feed, device=dev, name=tag)
        summary = rep.summary()
        out["legs"][tag] = {**summary, "corr_kernel": version, "kernels_vs_plain": {
            **{k: v for k, v in held.items() if k != "held"}, "launches_held": dict(held["held"])},
            "seconds": time.perf_counter() - t0}
        assert not summary["failed"], (tag, summary["failed"])
        assert held["correlation_max_abs_diff"] <= 2.4e-7, (tag, held)
        assert held["carve_cells_differing"] == 0 and held["check_counts_differing"] == 0, held
        assert held["held"]["ray_mark_image"] > 0 and held["held"]["bad_ray_count"] > 0, held
        del ref
    out["rounding_helpers_card_vs_cpu_bits_differing"] = bits = rounding_helpers_card_vs_cpu(dev)
    assert not any(bits.values()), bits
    out["seconds"] = time.perf_counter() - t_all
    return out


def pose_diff(a, b):
    """max |Δ| of two (N, 3) pose tensors, angles wrapped (±π agree)."""
    d = (a - b).abs()
    d[:, 2] = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2])).abs()
    return float(d.max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    import yaml

    from roborts_slam_tpu_torch import SlamEngine, load_config
    from roborts_slam_tpu_torch.__main__ import main as cli_main
    from roborts_slam_tpu_torch.backend.processor import BackendSpec
    from roborts_slam_tpu_torch.config import SlamConfig
    from roborts_slam_tpu_torch.frontend import matchers
    from roborts_slam_tpu_torch.io.scan_log import ScanLog
    from roborts_slam_tpu_torch.io.simulate import path_to_trajectory
    from roborts_slam_tpu_torch.utils.evaluation import ate_rmse, match_by_time
    from roborts_slam_tpu_torch.frontend.processor import (
        FrontendSpec, init_frontend_state,
    )
    from roborts_slam_tpu_torch.models.grid_map import (
        ProbMap, make_count_map, world_to_map_pose,
    )
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

    # ---- inputs: the willow log, and the corridor-loop log simulated here ----
    log = np.load(ROOT / "tests" / "data" / "golden_willow.npz")
    laser = LaserModel.from_array(log["laser"])
    ranges, odom, times = log["ranges"], log["odom"], log["times"]

    t0 = time.perf_counter()
    loop_traj = path_to_trajectory(corridor_loop_path(LOOP_LAPS), speed=1.0,
                                   scan_rate=10.0)
    loop_log = corridor_loop_log()
    loop_laser = loop_log.laser
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    log_path = os.path.join(tmp.name, "corridor_loop.npz")
    loop_log.save(log_path)

    def head_log(n):
        path = os.path.join(tmp.name, f"corridor_loop_{n}.npz")
        ScanLog(loop_log.ranges[:n], loop_log.odom[:n], loop_log.times[:n],
                loop_laser, loop_log.gt_poses[:n]).save(path)
        return path

    emit({"phase": "simulated_log", "scans": len(loop_log), "laps": LOOP_LAPS,
          "path_m": float(np.linalg.norm(np.diff(loop_traj[:, :2], axis=0), axis=1).sum()),
          "beams": loop_laser.num_beams, "seed": LOOP_SEED,
          "odom_end_error_m": float(np.linalg.norm(
              loop_log.odom[-1, :2] - (loop_log.gt_poses[-1, :2] - loop_log.gt_poses[0, :2]))),
          "seconds": time.perf_counter() - t0})

    # the three configurations the main paths run, at full width
    config = load_config(str(ROOT / "configs" / "simulation.yaml"),
                         max_points=1152, world_size=30.0)
    fspec = FrontendSpec.from_config(config, laser.range_max, 30.0)
    bspec = BackendSpec.from_config(config, laser.range_max, fspec.pub_spec)
    assert (fspec.fine_spec.height, bspec.fine_spec.height,
            fspec.pub_spec.height) == (3072, 2432, 640), "not the full width"
    # the real-robot profile: 0.025 m fine map in a 15 m window (640²), 1024²
    # chain maps and pub map, its own tier thresholds
    rr_config = load_config(str(ROOT / "configs" / "real_robot.yaml"))
    rr_fspec = FrontendSpec.from_config(rr_config, loop_laser.range_max)
    rr_bspec = BackendSpec.from_config(rr_config, loop_laser.range_max, rr_fspec.pub_spec)
    assert (rr_fspec.fine_spec.height, rr_bspec.fine_spec.height,
            rr_fspec.pub_spec.height, rr_config.max_points) == (640, 1024, 1024, 1152)
    # the default configuration as leg 4 runs it: 4096² fine map, 40 m world
    df_config = SlamConfig().replace(max_points=1152)
    df_fspec = FrontendSpec.from_config(df_config, loop_laser.range_max, 40.0)
    assert df_fspec.fine_spec.height == 4096, "not the full width"

    def scan_set(scan_ranges, scan_laser, poses, n=18):
        """The first ``n`` scans of a log on the card, packed to 1152 points."""
        packed = [ranges_to_packed(scan_ranges[i], scan_laser, 1152) for i in range(n)]
        return {"pts": [torch.as_tensor(p[0], device=dev) for p in packed],
                "msk": [torch.as_tensor(p[1], device=dev) for p in packed],
                "nvs": [p[2] for p in packed],
                "poses": [torch.as_tensor(poses[i], **f32) for i in range(n)]}

    willow_scans = scan_set(ranges, laser, odom)
    loop_scans = scan_set(loop_log.ranges, loop_laser, loop_log.odom)
    LEG1, LEG2 = "main_path", "main_path_back_end"
    LEG3, LEG4 = "main_path_real_robot", "main_path_default_config"
    LEG5 = "main_path_async"
    LOCKSTEP = "kernel_vs_plain_lockstep"

    # ---- phase 3: every kernel against its plain version, on the card, at
    # the shapes of every main path ----
    K1 = dict(fn=correlation.correlation_scores, name="correlation_scores", version=1,
              source="roborts_slam_tpu_torch/ops/cuda/correlation.cu",
              replaces="roborts_slam_tpu/ops/pallas/correlation.py:206")
    K2 = dict(fn=correlation.correlation_scores_v2, name="correlation_scores_v2", version=2,
              source="roborts_slam_tpu_torch/ops/cuda/correlation_v2.cu",
              replaces="roborts_slam_tpu/ops/pallas/correlation.py:407")
    entries = {}          # what the last ``kernels`` line lists
    counted_as = {}       # entry key -> which per-shape launch counts it reads
    optional = set()      # entries that a leg need not have launched
    both_kernels = []     # every shape, both correlation kernels side by side
    # shapes held against the plain versions: (B, A, S, N, H, W) of the
    # correlation kernels, (P, H, W) of the carve, (B, R, H, W) of the ray check
    compared_corr, compared_mark, compared_check = set(), set(), set()

    def compare_kernels(what, args, want):
        """Both correlation kernels on ``args`` against the plain version's
        ``want`` (bar 1e-5) and, bit for bit, against each other, against the
        plain version with the sums in the kernels' order, and against a
        second launch of themselves. Returns ({name: max|Δ|}, max|K2 − K1|)."""
        B, H, W = args[0].shape
        _, A, S = args[1].shape
        slice_len = correlation.launch_geometry(A, S, args[4].shape[1], H, W).slice_len
        sliced = correlative.correlation_scores_sliced(*args, slice_len)
        got = {k["name"]: k["fn"](*args) for k in (K1, K2)}
        again = {k["name"]: k["fn"](*args) for k in (K1, K2)}
        torch.cuda.synchronize()
        errs = {}
        for kname, g in got.items():
            errs[kname] = float((g - want).abs().max())
            assert errs[kname] <= 1e-5, f"{what}: {kname} vs plain {errs[kname]}"
            assert bool(torch.isfinite(g).all()), f"{what}: {kname} not finite"
            assert torch.equal(g, again[kname]), f"{what}: {kname} differs between two launches"
            assert torch.equal(g, sliced), f"{what}: {kname} is not the sliced sum"
        return errs, float((got[K2["name"]] - got[K1["name"]]).abs().max())

    def second_kernel_paths(args):
        """Which way the second kernel takes on ``args``, restated from its
        geometry: the share of blocks that stage boxes at all (the others
        span more cells than they have candidates and walk as the first
        kernel does) and, in those, the share of valid samples whose box is
        copied whole, with the mean cells of such a box."""
        p_, rx, ry, sv, xs, ys, _, _ = args
        H, W = p_.shape[-2:]
        A, N = rx.shape[1], xs.shape[1]
        g = correlation.launch_geometry(A, rx.shape[2], N, H, W)
        span_x = torch.floor(xs[:, -1] - xs[:, 0]).clamp(min=1)
        staging, boxed, cells, samples = 0, 0, 0, 0
        for ky0 in range(0, N, g.v2_rows):
            gys = ys[:, ky0:ky0 + g.v2_rows]
            ncand = min(gys.shape[1] * N, g.v2_team * g.v2_slots)
            stages = span_x * torch.floor(gys[:, -1] - gys[:, 0]).clamp(min=1) <= ncand
            staging += int(stages.sum()) * A
            box = correlation.box_layout(rx, ry, xs, gys, H, W, ncand)
            use = (stages[:, None, None] & sv[:, None, :]).expand_as(box["boxed"])
            whole = use & box["boxed"] & (box["height"] > 0)
            samples += int(use.sum())
            boxed += int(whole.sum())
            cells += int((box["width"] * box["height"])[whole].sum())
        blocks = p_.shape[0] * A * g.v2_groups
        return {"rows_per_block": g.v2_rows, "lanes_per_team": g.v2_team,
                "slots_per_lane": g.v2_slots, "blocks": blocks,
                "blocks_staging_share": staging / blocks,
                "samples_boxed_share": boxed / samples if samples else 0.0,
                "mean_box_cells": cells / boxed if boxed else 0.0,
                "candidates_per_block": g.v2_rows * N}

    def corr_entries(spec, tier_params, probs, offset, poses, points, n_valid,
                     key, listed, leg):
        """Both correlation kernels against the one plain version on one
        shape per tier; ``listed`` names the kernel whose entries go into the
        ``kernels`` line (the one ``leg`` runs at this shape)."""
        for tname, params in tier_params.items():
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
            want = correlative.correlation_scores_plain(*args)
            errs, k2_minus_k1 = compare_kernels(f"{key}:{tname}", args, want)
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
            cost = tier_cost(tname, p_.shape, rx, ry, sv, xs, ys)
            bms, by = bound(cost.hbm_bytes, cost.operations)
            # the two kernels and the yardstick in turns, inside this run
            calls = {k["name"]: (lambda k=k: k["fn"](*args)) for k in (K1, K2)}
            calls["library"] = lib
            turns = (K1["name"], K2["name"], "library", "library", K2["name"], K1["name"])
            ms = in_turns(lambda f: time_ms(f, reps=10), calls, turns)
            host = in_turns(host_us, calls, turns)
            out = torch.empty_like(want)
            dev_us = {k["name"]: device_us(correlation.prepared_launch(
                k["version"], *args, out)) for k in (K1, K2)}
            dev_us["library"] = device_us(lib)
            shared = {
                "shape": [B, A, S, N, H, W],
                "plain_ms": time_ms(
                    lambda: correlative.correlation_scores_plain(*args)),
                "bound_ms": bms, "bound_by": by,
                "library_ms": ms["library"],
                "library_device_us": dev_us["library"],
                "library_host_us": host["library"],
                "cells_touched": cost.cells,
            }
            compared_corr.add((B, A, S, N, H, W))
            for k in (K1, K2):
                entry = {"name": f"{k['name']}[{key}:{tname}]", "route": "cuda",
                         "source": k["source"], "replaces": k["replaces"],
                         "launches": 0, "launches_from": leg,
                         "max_abs_err": errs[k["name"]],
                         "ms": ms[k["name"]], "device_us": dev_us[k["name"]],
                         "host_us": host[k["name"]],
                         "loses_by": ms[k["name"]] / ms["library"],
                         "repeats_its_bits": True, **shared}
                if k is K2:
                    # what the staging of boxes costs or saves: the same
                    # kernel with every candidate reading its own cell
                    walked = torch.empty_like(want)
                    entry["walk_device_us"] = device_us(correlation.prepared_launch(
                        2, *args, walked, stage_boxes=False))
                    assert torch.equal(walked, out), f"{key}:{tname}: walk differs"
                    entry["box"] = second_kernel_paths(args)
                both_kernels.append({**entry, "max_abs_k2_minus_k1": k2_minus_k1})
                if k is listed:
                    entries[f"{key}:{tname}"] = entry
                    counted_as[f"{key}:{tname}"] = ("corr", k["version"], B, A, S, N, H, W)

    def check_args(cfg, ps, pub, points, pmask, n_valid, poses):
        """Arguments of ``bad_ray_count`` as ``map_feedback_penalty`` forms
        them for ``poses`` (B, 3)."""
        pose_map = world_to_map_pose(pub.offset, ps.inv_res, poses)
        s, e, ok, thr_d2 = raycast.check_rays(
            ps, pose_map, points, pmask, n_valid, cfg.map_check_point_num,
            cfg.map_check_bound_tolerance)
        return (s.contiguous(), e.contiguous(), ok.contiguous(), pub.hits, pub.passes,
                cfg.map_min_passthrough, cfg.map_occu_threshold, thr_d2)

    Q = 12                 # the scan every comparison matches or carves

    def start_poses(scans, B):
        """The pose the comparisons start scan ``Q`` from, and ``B`` start
        poses around it (a chain batch holds at most 8)."""
        pose_q = scans["poses"][Q] + torch.as_tensor([0.03, -0.02, 0.01], **f32)
        return pose_q, pose_q[None] + torch.as_tensor(NUDGE[:B], **f32)

    def pub_entries(ctx, ps, leg, batches, carve=True):
        """The carve kernel and the ray-check kernel (one batch size per
        entry of ``batches``) against their plain versions on a pub map of
        ``ps``'s shape, made here from ten scans. Returns the map."""
        cfg, scans = ctx["cfg"], ctx["scans"]
        key = f"{ctx['tag']}pub_{ps.height}x{ps.width}"
        points, pmask, n_valid = scans["pts"][Q], scans["msk"][Q], scans["nvs"][Q]
        pose_q = start_poses(scans, 1)[0]
        pub = make_count_map(ps, [ps.width * ps.resolution * cfg.map_offset_x,
                                  ps.height * ps.resolution * cfg.map_offset_y], dev)
        if carve:
            start, end, beam_mask = (t.contiguous() for t in raster._scan_cells(
                ps.inv_res, pub.offset, points, pmask, pose_q))
            carve_call = lambda: raycarve.ray_mark_image(
                start, end, beam_mask, ps.height, ps.width)
            got, again = carve_call(), carve_call()
            want = raster.mark_image_plain(start, end, beam_mask, ps.height, ps.width)
            torch.cuda.synchronize()
            differing = int((got != want).sum())
            assert differing == 0, f"ray_mark_image[{key}]: {differing} cells differ"
            assert torch.equal(got, again), f"ray_mark_image[{key}] differs between two launches"
            assert int((got == 2).sum()) > 0 and int((got == 1).sum()) > 0
            delta = (end - start[None]).abs().amax(-1).clamp(min=1)
            ray_cells = int((delta + 1)[beam_mask].sum())
            bms, by = bound(ps.height * ps.width * 4 + end.numel() * 4
                            + beam_mask.numel() + 8, ray_cells * 12)
            P = int(end.shape[0])
            # every design through the bound C function, in turns, forwards
            # and backwards (``ray_mark_image`` launches the first)
            designs = raycarve.MARK_DESIGNS
            assert designs["beam_major"] == raycarve.MARK_DESIGN
            images = {d: torch.full_like(got, 7) for d in designs}
            bare = {d: raycarve.prepared_mark_launch(start, end, beam_mask, images[d], k)
                    for d, k in designs.items()}
            dev_us = in_turns(device_us, bare, tuple(designs) + tuple(designs)[::-1])
            torch.cuda.synchronize()
            for d, image in images.items():
                assert torch.equal(image, want), f"ray_mark_image[{key}]: {d} differs"
            entries[f"{key}:carve"] = {
                "name": f"ray_mark_image[{key}]", "route": "cuda",
                "source": "roborts_slam_tpu_torch/ops/cuda/raycarve.cu",
                "replaces": "roborts_slam_tpu/ops/pallas/raycarve.py:57",
                "shape": [P, ps.height, ps.width], "launches": 0, "launches_from": leg,
                "max_abs_err": float(differing),
                "ms": time_ms(carve_call),
                "device_us": dev_us["beam_major"],
                "tile_major_device_us": dev_us["tile_major"],
                "beam_major_memset_device_us": dev_us["beam_major_memset"],
                "beam_major_look_device_us": dev_us["beam_major_look"],
                "host_us": host_us(carve_call),
                "bare_host_us": host_us(bare["beam_major"]),
                "repeats_its_bits": True,
                "plain_ms": time_ms(lambda: raster.mark_image_plain(
                    start, end, beam_mask, ps.height, ps.width)),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "ray_cells": ray_cells,
            }
            counted_as[f"{key}:carve"] = ("mark", P, ps.height, ps.width)
            compared_mark.add((P, ps.height, ps.width))

        # check: rays against the pub map carved from the first scans
        for i in range(10):
            raster.update_count_map(ps, pub, scans["pts"][i], scans["msk"][i],
                                    scans["poses"][i], 0.3, 0.7)
        for B in batches:
            poses = start_poses(scans, B)[1]
            args = check_args(cfg, ps, pub, points, pmask, n_valid, poses)
            s, e, ok = args[:3]
            check_call = lambda: raycarve.bad_ray_count(*args)
            got, again = check_call(), check_call()
            want = raycast.bad_rays_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"bad_ray_count[{key}_b{B}]: {got} vs {want}"
            assert torch.equal(got, again), f"bad_ray_count[{key}_b{B}] differs between two launches"
            n = (e - s[:, None, :]).abs().amax(-1).clamp(min=1)
            visited = int((n + 1)[ok].sum())
            bms, by = bound(visited * 8 + e.numel() * 4 + s.numel() * 4 + ok.numel()
                            + got.numel() * 4, visited * 20)
            # displaced poses, where many rays DO cross occupied cells
            far_args = check_args(cfg, ps, pub, points, pmask, n_valid,
                                  poses + torch.as_tensor([0.6, -0.4, 0.5], **f32))
            bad = raycarve.bad_ray_count(*far_args)
            assert torch.equal(bad, raycast.bad_rays_plain(*far_args)) \
                and int(bad.sum()) > 0, (key, B, bad)
            R = int(ok.shape[1])
            # with the ticket reduction (shipped) and with a zeroed count and
            # atomic adds, through the bound C function, in turns
            counts = {d: torch.full_like(got, 7) for d in ("ticket", "memset_atomic")}
            bare = {d: raycarve.prepared_check_launch(*args, counts[d], ticket=d == "ticket")
                    for d in counts}
            dev_us = in_turns(device_us, bare,
                              ("ticket", "memset_atomic", "memset_atomic", "ticket"))
            torch.cuda.synchronize()
            for d, count in counts.items():
                assert torch.equal(count, want), f"bad_ray_count[{key}_b{B}]: {d} {count}"
            entries[f"{key}:check_b{B}"] = {
                "name": f"bad_ray_count[{key}_b{B}]", "route": "cuda",
                "source": "roborts_slam_tpu_torch/ops/cuda/raycarve.cu",
                "replaces": "roborts_slam_tpu/ops/pallas/raycarve.py:164",
                "shape": [B, R, ps.height, ps.width],
                "launches": 0, "launches_from": leg,
                "max_abs_err": float((got - want).abs().max()),
                "counts": got.tolist(), "counts_displaced": bad.tolist(),
                "ms": time_ms(check_call),
                "device_us": dev_us["ticket"],
                "memset_atomic_device_us": dev_us["memset_atomic"],
                "host_us": host_us(check_call),
                "bare_host_us": host_us(bare["ticket"]),
                "repeats_its_bits": True,
                "plain_ms": time_ms(lambda: raycast.bad_rays_plain(*args)),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "rays": int(ok.sum()), "cells_on_rays": visited,
            }
            counted_as[f"{key}:check_b{B}"] = ("check", B, R, ps.height, ps.width)
            compared_check.add((B, R, ps.height, ps.width))
        return pub

    def chain_entries(ctx, B, leg):
        """Both correlation kernels against the plain version on ``B`` chain
        maps of the configuration's back end, ten scans each."""
        scans, bs = ctx["scans"], ctx["chain_spec"]
        pts, msk, poses = scans["pts"], scans["msk"], scans["poses"]
        chain_ids = [list(range(b, b + 10)) for b in range(B)]
        cp = torch.stack([torch.stack([pts[i] for i in c]) for c in chain_ids])
        cm = torch.stack([torch.stack([msk[i] for i in c]) for c in chain_ids])
        cpo = torch.stack([torch.stack([poses[i] for i in c]) for c in chain_ids])
        size = bs.width * bs.resolution
        boff = torch.stack([-(poses[Q][0] - 0.5 * size), -(poses[Q][1] - 0.5 * size)])
        chain_maps = raster.stamp_scan_batch(
            bs, ProbMap(torch.full((B, bs.height, bs.width), bs.default_prob, **f32), boff),
            cp, cm, cpo, torch.ones((B, 10), dtype=torch.bool, device=dev))
        corr_entries(bs, ctx["tiers"], chain_maps.probs, boff, start_poses(scans, B)[1],
                     pts[Q], scans["nvs"][Q], f"{ctx['tag']}chain_b{B}", ctx["listed"], leg)

    def compare_config(tag, cfg, fs_, chain_spec, scans, listed, leg, chain_leg):
        """Every kernel against its plain version at one configuration's
        shapes: the front end's fine map (B=1), the back end's chain maps
        (one chain and four, where ``chain_leg`` runs chain matches) and the
        pub map (one pose and four). Returns what ``account`` needs to
        compare further batch sizes, the front-end state and the pub map."""
        ctx = {"tag": tag, "cfg": cfg, "fs": fs_, "chain_spec": chain_spec,
               "scans": scans, "listed": listed,
               "tiers": {"coarse": fs_.matcher.coarse, "fine": fs_.matcher.fine,
                         "super_fine": fs_.matcher.super_fine}}
        st = init_frontend_state(fs_, dev)
        for i in range(10):
            raster.stamp_scan(fs_.fine_spec, st.fine, scans["pts"][i], scans["msk"][i],
                              scans["poses"][i])
        corr_entries(fs_.fine_spec, ctx["tiers"], st.fine.probs, st.fine.offset,
                     start_poses(scans, 1)[0], scans["pts"][Q], scans["nvs"][Q],
                     f"{tag}front_b1", listed, leg)
        if chain_leg is not None:
            # a batch is padded to a bucket, and a fused step's batch holds
            # near and loop chains: which sizes a leg launches depends on it
            # (the last line checks that each leg launched one of them)
            chain_entries(ctx, 1, chain_leg)
            chain_entries(ctx, 4, chain_leg)
            optional.update(f"{tag}chain_b{b}:{t}" for b in (1, 4) for t in ctx["tiers"])
        pub = pub_entries(ctx, fs_.pub_spec, leg, (1, 4))
        optional.add(f"{tag}pub_{fs_.pub_spec.height}x{fs_.pub_spec.width}:check_b4")
        return ctx, st, pub

    # legs 1-2: 3072² fine map, 2432² chain maps, 640² pub map, first kernel
    ctx_sim, state, pub = compare_config(
        "", config, fspec, bspec.fine_spec, willow_scans, K1, LEG1, LEG2)
    # leg 3: 640² window map, 1024² chain maps and pub map, second kernel
    ctx_rr = compare_config("rr_", rr_config, rr_fspec, rr_bspec.fine_spec,
                            loop_scans, K2, LEG3, LEG3)[0]
    ctx_rr1 = {**ctx_rr, "listed": K1}       # the real-robot shapes, first kernel
    # leg 4: 4096² fine map, 896² pub map, first kernel; its 200 scans
    # propose no chain match (the windowed short leg matches one 2432² map,
    # the shape of the simulation profile's single chain map)
    ctx_df = compare_config("default_", df_config, df_fspec, None, loop_scans,
                            K1, LEG4, None)[0]
    ctx_df["chain_spec"] = BackendSpec.from_config(
        df_config, loop_laser.range_max, df_fspec.pub_spec).fine_spec
    emit({"phase": "correlation_kernels",
          "timed": "ms: CUDA events round 10 back-to-back wrapper calls, warm, median "
          "of 10 runs; host_us: host clock per wrapper call over 200 calls, no "
          "synchronise inside; both for first kernel, second kernel and library "
          "call in turns (k1, k2, library, library, k2, k1), the mean of the two; "
          "device_us: 100 launches in one CUDA graph, replayed between two events, "
          "median of 7 (the kernels through the bound C function, arguments "
          "prepared once); loses_by = ms / library_ms",
          "entries": both_kernels})
    emit({"phase": "ray_kernels",
          "timed": "ms: CUDA events round 10 back-to-back wrapper calls, warm, median "
          "of 20 runs; host_us: host clock per wrapper call over 200 calls, no "
          "synchronise inside (bare_host_us: the same for the bound C function, "
          "arguments prepared once); device_us: 100 launches in one CUDA graph, "
          "replayed between two events, median of 7, through the bound C function, "
          "the designs in turns, forwards and backwards, the mean of the two. Carve: "
          "device_us is the design ray_mark_image launches (a fill kernel and a warp "
          "per beam that starts while it runs), tile_major_device_us a block per "
          "32 x 32 tile in one launch, beam_major_memset_device_us the same walk "
          "behind cudaMemsetAsync, beam_major_look_device_us 16 lanes per beam and a "
          "load before each atomic behind cudaMemsetAsync. Check: device_us is one "
          "launch with one packed atomic per block, memset_atomic_device_us a zeroed "
          "count and atomic adds",
          "carve_designs": raycarve.MARK_DESIGNS, "carve_shipped": raycarve.MARK_DESIGN,
          "earlier": EARLIER_RAY_KERNELS,
          "entries": [e for e in entries.values()
                      if e["name"].startswith(("ray_mark_image[", "bad_ray_count["))]})
    # the same slices and the same order of sums: the two kernels agree bit for bit
    assert max(e["max_abs_k2_minus_k1"] for e in both_kernels) == 0.0
    main_rows = [e for e in both_kernels if e["shape"][0] == 1 and (
        (e["name"].startswith(K2["name"] + "[")) == e["name"].split("[")[1].startswith("rr_"))]
    first_front = {e["name"].split(":")[1].rstrip("]"): e["device_us"] for e in both_kernels
                   if e["name"].startswith(K1["name"] + "[front_b1:")}
    emit({"phase": "correlation_vs_library", "rows": len(main_rows),
          "slower_than_library": [
              {"name": e["name"], "loses_by": e["loses_by"], "ms": e["ms"],
               "library_ms": e["library_ms"], "device_us": e["device_us"],
               "host_us": e["host_us"]} for e in main_rows if e["loses_by"] > 1.0],
          "first_kernel_front_device_us": first_front,
          "super_fine_no_slower_than_coarse":
              first_front["super_fine"] <= first_front["coarse"]})

    # edge cases, kernel against plain version (not timed): rays that leave
    # the map on the low side (negative DDA numerators: the kernels' floor
    # division), a sensor outside the map, an empty scan, a pose far outside
    q = Q
    pts, msk, nvs = willow_scans["pts"], willow_scans["msk"], willow_scans["nvs"]
    ps, tiers = fspec.pub_spec, ctx_sim["tiers"]
    pose_q = start_poses(willow_scans, 1)[0]
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
    args = check_args(config, ps, pub, pts[q], msk[q], nvs[q],
                      torch.stack([corner, outside, pose_q]))
    got, want = raycarve.bad_ray_count(*args), raycast.bad_rays_plain(*args)
    assert torch.equal(got, want), (got, want)
    edge["check_counts"] = got.tolist()
    # more of the same on small made-up scans, every carve design and both
    # reductions of the check: beams of length 0 and 1, every beam masked, a
    # sensor outside the map whose rays cross it, rays that leave on the high
    # side, rays longer than the check's unrolled 256 steps (a 4096-cell map),
    # rays the kernels walk in 64 bits, 8 poses, maps that are not square
    def fan(seed, beams, sensor, reach):
        rng = np.random.default_rng(seed)
        ang, r = rng.uniform(0, 2 * np.pi, beams), rng.uniform(0, reach, beams)
        cells = np.floor(np.stack([sensor[0] + r * np.cos(ang),
                                   sensor[1] + r * np.sin(ang)], -1) + 0.5)
        return (torch.as_tensor(sensor, dtype=torch.int32, device=dev),
                torch.as_tensor(cells.astype(np.int32), device=dev),
                torch.as_tensor(rng.random(beams) < 0.9, device=dev))

    i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    st, en, bm = fan(4, 300, (47, 61), 70)
    small = {
        "length_0_and_1": (i32([10, 12]), i32([[10, 12], [11, 12], [10, 11], [9, 13]]),
                           ones(4), 40, 48),
        "every_beam_masked": (st, en, torch.zeros_like(bm), 96, 128),
        "sensor_outside_rays_cross": (*fan(6, 300, (-25, -10), 160), 96, 128),
        "rays_leave_high_side": (*fan(7, 300, (120, 90), 80), 96, 128),
        "n_above_256_on_4096": (i32([5, 17]), i32([[4090, 30], [300, 0], [4095, 17], [700, 39]]),
                                ones(4), 40, 4096),
        "needs_64_bits": (i32([-40000, 5]), i32([[60, 30], [100, -20], [-39990, 8]]),
                          ones(3), 40, 128),
        "non_square_non_multiple": (*fan(5, 300, (33, 20), 90), 70, 101),
    }
    rng = np.random.default_rng(8)
    for name, (st, en, bm, H, W) in small.items():
        want = raster.mark_image_plain(st, en, bm, H, W)
        got = raycarve.ray_mark_image(st, en, bm, H, W)
        assert torch.equal(got, want), f"ray_mark_image[{name}] differs"
        assert torch.equal(got, raycarve.ray_mark_image(st, en, bm, H, W)), name
        for d, k in raycarve.MARK_DESIGNS.items():
            image = torch.full_like(want, 7)
            raycarve.prepared_mark_launch(st, en, bm, image, k)()
            assert torch.equal(image, want), f"ray_mark_image[{name}]: {d} differs"
        edge[f"carve_{name}_cells"] = int((want > 0).sum())
        # the same rays from 8 poses a few cells apart, on random count planes
        B = 8
        passes = torch.as_tensor(rng.integers(0, 6, (H, W)).astype(np.float32), device=dev)
        hits = torch.as_tensor((rng.random((H, W)) * rng.integers(0, 2, (H, W)))
                               .astype(np.float32), device=dev) * passes
        shift = i32(rng.integers(-3, 4, (B, 2)))
        args = ((st[None] + shift).contiguous(), (en[None] + shift[:, None]).contiguous(),
                bm[None].repeat(B, 1).contiguous(), hits, passes, 2.0, 0.4, 2)
        want = raycast.bad_rays_plain(*args)
        got = raycarve.bad_ray_count(*args)
        assert torch.equal(got, want), (name, got, want)
        assert torch.equal(got, raycarve.bad_ray_count(*args)), name
        for ticket in (True, False):
            count = torch.full_like(want, 7)
            raycarve.prepared_check_launch(*args, count, ticket=ticket)()
            assert torch.equal(count, want), (name, ticket, count, want)
        edge[f"check_{name}_b8"] = want.tolist()
    # the shipped carve's walk starts while its fill still runs: with nothing
    # to walk it must still not end before the fill, so that what follows on
    # the stream (no synchronise in between) sees a large image zeroed
    big = torch.full((4096, 4096), 7, dtype=torch.int32, device=dev)
    st, en, bm = small["every_beam_masked"][:3]
    raycarve.prepared_mark_launch(st, en, bm, big)()
    edge["carve_every_beam_masked_4096_nonzero_cells"] = int((big != 0).sum())
    assert edge["carve_every_beam_masked_4096_nonzero_cells"] == 0
    del big
    assert edge["carve_every_beam_masked_cells"] == 0
    assert edge["check_every_beam_masked_b8"] == [0] * 8
    assert edge["carve_needs_64_bits_cells"] > 0 and sum(edge["check_n_above_256_on_4096_b8"]) > 0
    assert min(edge[f"carve_{n}_cells"] for n in small if n != "every_beam_masked") > 0
    fs = fspec.fine_spec
    far = torch.as_tensor([500.0, -400.0, 0.1], **f32)
    # a pose near the map's low corner: part of every window falls off the
    # low side (negative cell coordinates), part lies inside
    low = torch.as_tensor([-15.3, -15.2, 0.4], **f32)
    for k, tag in ((K1, "score"), (K2, "score_v2")):
        for name, pose, n_valid in (("empty_scan", pose_q, 0),
                                    ("far_pose", far, nvs[q]),
                                    ("low_side", low, nvs[q])):
            center = world_to_map_pose(state.fine.offset, fs.inv_res, pose)
            g = correlative.candidate_grid(fs, tiers["coarse"], pts[q], n_valid, center)
            args = (state.fine.probs[None], g.rx[None].contiguous(),
                    g.ry[None].contiguous(), g.svalid[None].contiguous(),
                    g.xs[None].contiguous(), g.ys[None].contiguous(),
                    float(fs.default_prob), torch.full((1,), g.divisor, **f32))
            got = k["fn"](*args)
            want = correlative.correlation_scores_plain(*args)
            assert float((got - want).abs().max()) <= 1e-5, (k["name"], name)
            assert bool(torch.isfinite(got).all())
            edge[f"{tag}_{name}"] = float(got.mean())
            if name == "low_side":
                cells_x = torch.floor(g.rx[..., None] + g.xs[None, None, :] + 0.5)
                assert bool((cells_x < 0).any()) and bool((cells_x >= 0).any())
                continue
            # every valid sample falls outside the map: default_prob each
            expect = fs.default_prob * int(g.svalid.sum()) / g.divisor
            assert abs(edge[f"{tag}_{name}"] - expect) < 1e-5, (name, expect)
        assert edge[f"{tag}_empty_scan"] == 0.0
    # what the sliced design opens, on synthetic windows from a seed: each
    # case holds both kernels against the plain version (1e-5) and, bit for
    # bit, against each other, the sliced sum and a second launch
    def window_case(seed, B, A, S, N, H, W, step, center, n_valid=None,
                    prefix=True, ordered=True):
        """A (B, H, W) map of random values, samples within 30 cells of the
        sensor, an N x N window of ``step`` cells round ``center``."""
        rng = np.random.default_rng(seed)
        probs_ = torch.as_tensor(rng.random((B, H, W), dtype=np.float32))
        rx_ = torch.as_tensor(rng.uniform(-30, 30, (B, A, S)).astype(np.float32))
        ry_ = torch.as_tensor(rng.uniform(-30, 30, (B, A, S)).astype(np.float32))
        n_valid = S if n_valid is None else n_valid
        sv_ = (torch.arange(S)[None].expand(B, S) < n_valid) if prefix \
            else torch.as_tensor(rng.random((B, S)) < 0.5)
        c = torch.as_tensor(np.asarray(center, np.float32)
                            + rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32))
        steps = torch.arange(N, dtype=torch.float32) * step
        if not ordered:
            steps = steps[torch.as_tensor(rng.permutation(N))]
        half = (N - 1) * step * 0.5
        tensors = (probs_, rx_, ry_, sv_, c[:, 0:1] - half + steps,
                   c[:, 1:2] - half + steps)
        return (*[t.contiguous().to(dev) for t in tensors], 0.37,
                torch.full((B,), float(max(n_valid, 1)), **f32))

    design_cases = {
        # S not a multiple of the slice length, one valid sample
        "s_prime_one_valid": (1, 1, 2, 37, 3, 64, 64, 1.0, (30, 30), 1),
        "one_sample": (2, 1, 2, 1, 3, 64, 64, 1.0, (30, 30)),
        "one_candidate": (3, 1, 2, 19, 1, 64, 64, 1.0, (30, 30)),
        # boxes that straddle the map's low and high edges, and lie wholly outside
        "low_edges_step_2": (4, 1, 2, 40, 11, 200, 220, 2.0, (20, 25)),
        "high_edges_step_0.8": (5, 1, 2, 40, 11, 200, 220, 0.8, (190, 200)),
        "low_x_high_y_step_1": (6, 2, 2, 80, 3, 200, 220, 1.0, (3, 198)),
        "wholly_outside": (7, 1, 2, 40, 11, 200, 220, 2.0, (900, -700)),
        # the real-robot profile's steps: several candidates on one cell
        "step_0.8": (8, 1, 2, 40, 11, 200, 220, 0.8, (100, 110)),
        "step_0.4": (9, 1, 2, 80, 3, 200, 220, 0.4, (100, 110)),
        # a window of more candidates than a block has threads
        "window_33x33": (10, 1, 1, 17, 33, 100, 100, 1.0, (50, 50)),
        "window_200x200": (11, 1, 1, 9, 200, 300, 300, 1.0, (150, 150)),
        # slices longer than eight samples, a mask that is no prefix,
        # offsets in no order
        "5000_samples": (12, 1, 2, 5000, 3, 64, 64, 1.0, (30, 30)),
        "mask_not_a_prefix": (13, 2, 2, 45, 11, 200, 220, 0.8, (100, 110), None, False),
        "offsets_unordered": (14, 2, 2, 40, 9, 200, 220, 0.8, (15, 205), None, True, False),
    }
    for name, spec_ in design_cases.items():
        args = window_case(*spec_)
        errs, k2_minus_k1 = compare_kernels(name, args,
                                            correlative.correlation_scores_plain(*args))
        assert k2_minus_k1 == 0.0, (name, k2_minus_k1)
        edge[f"design_{name}"] = max(errs.values())
    torch.cuda.synchronize()
    emit({"phase": "kernels_checked", "edge_cases": edge, "entries": len(entries),
          "correlation_shapes": sorted(compared_corr),
          "carve_shapes": sorted(compared_mark),
          "check_shapes": sorted(compared_check)})
    del state, pub
    torch.cuda.empty_cache()

    # ---- launch counts: set to 0 before a leg, read after it ----
    def reset_counts():
        correlation.launches = correlation.launches_v2 = 0
        raycarve.mark_launches = raycarve.check_launches = 0
        for by_shape in (correlation.launch_shapes, raycarve.mark_shapes,
                         raycarve.check_shapes):
            by_shape.clear()

    def read_counts():
        return {"correlation_scores": correlation.launches,
                "correlation_scores_v2": correlation.launches_v2,
                "ray_mark_image": raycarve.mark_launches,
                "bad_ray_count": raycarve.check_launches}

    def read_shapes():
        return {"corr": dict(correlation.launch_shapes),
                "mark": dict(raycarve.mark_shapes),
                "check": dict(raycarve.check_shapes)}

    def shapes_said(shapes):
        return {kind: {"x".join(map(str, k)): v for k, v in sorted(by.items())}
                for kind, by in shapes.items()}

    def on_maps_of(shapes, version, spec):
        """Launches of one correlation kernel on maps of ``spec``'s shape."""
        return sum(v for k, v in shapes["corr"].items()
                   if k[0] == version and k[5:] == (spec.height, spec.width))

    def account(leg, shapes, ctx):
        """After a leg: every shape it launched a kernel at and that was not
        yet held against the plain version (a chain batch of another size, a
        pub map that grew) is compared now, or the leg fails; then the
        launches of the entries listed for the leg are filled in."""
        for ver, B, *rest in sorted(shapes["corr"]):
            if (B, *rest) in compared_corr:
                continue
            bs = ctx["chain_spec"] if ctx else None
            assert bs is not None and tuple(rest[3:]) == (bs.height, bs.width), \
                f"{leg}: correlation shape {(ver, B, *rest)} not compared"
            chain_entries(ctx, B, leg)
            optional.update(f"{ctx['tag']}chain_b{B}:{t}" for t in ctx["tiers"])
        maps = {k[1:] for k in shapes["mark"]} | {k[2:] for k in shapes["check"]}
        for H, W in sorted(maps):
            batches = sorted({k[0] for k in shapes["check"]
                              if k[2:] == (H, W) and k not in compared_check})
            carve = any(k[1:] == (H, W) and k not in compared_mark
                        for k in shapes["mark"])
            if batches or carve:
                ps_ = dataclasses.replace(ctx["fs"].pub_spec, height=H, width=W)
                before = set(entries)
                pub_entries(ctx, ps_, leg, batches, carve=carve)
                optional.update(set(entries) - before)
        for kind, launched in shapes.items():
            held = {"corr": compared_corr, "mark": compared_mark,
                    "check": compared_check}[kind]
            for k in launched:
                assert (k[1:] if kind == "corr" else k) in held, (leg, kind, k)
        for key, e in entries.items():
            if e["launches_from"] != leg or e["launches"] > 0:
                continue
            kind, *m = counted_as[key]
            e["launches"] = shapes[kind].get(tuple(m), 0)
            assert e["launches"] > 0 or key in optional, \
                f"{e['name']}: not launched on {leg}"

    def relist_rr_k1(phase, kinds, optional_if):
        """The real-robot entries of ``kinds`` ("corr": the first kernel's
        correlation rows; "mark", "check") listed again for ``phase``'s
        launches, which run the first kernel on those shapes. A copy is
        optional (``phase`` need not launch it) where ``optional_if(key)``."""
        def copy(key, e, counted):
            new = f"{key}@{phase}"
            entries[new] = {**e, "launches": 0, "launches_from": phase,
                            "name": e["name"][:-1] + f"@{phase}]"}
            counted_as[new] = counted
            if optional_if(key):
                optional.add(new)

        for key, e in list(entries.items()):
            kind = counted_as[key][0]
            if key.startswith("rr_") and "@" not in key and kind != "corr" and kind in kinds:
                copy(key, e, counted_as[key])
        if "corr" in kinds:
            for e in both_kernels:
                if e["name"].startswith(K1["name"] + "[rr_"):
                    copy(e["name"][len(K1["name"]) + 1:-1],
                         {k: v for k, v in e.items() if k != "max_abs_k2_minus_k1"},
                         ("corr", 1, *e["shape"]))

    # ---- phase 4: the main path at full width ----
    # 70 scans out, then the same 70 in reverse order with times continuing
    # upward: an out-and-back run over identical poses
    order, feed_times = parity.willow_out_and_back(log)

    def drive(cfg):
        """One out-and-back run through the public entry points; returns the
        engine, its report and the kernels' launch counts by shape."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        eng = SlamEngine(cfg, laser, world_size=30.0)
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
        counts, shapes = read_counts(), read_shapes()
        kept = len(eng.store)
        traj = eng.trajectory_array()
        chain_corr = on_maps_of(shapes, 1, eng.bspec.fine_spec)
        # chain batches: the separate ones and those that rode a fused step
        batches = eng.backend.num_chain_dispatches + eng.diag.fused_steps
        report = {
            "scans_fed": len(order), "kept": kept, "links": eng.backend.num_links,
            "loop_closures": eng.backend.num_loop_closures,
            "spa_solves": eng.backend.num_solves,
            "chain_dispatches": eng.backend.num_chain_dispatches,
            "fused_steps": eng.diag.fused_steps,
            "fused_hits": eng.backend.num_fused_hits,
            "fused_misses": eng.backend.num_fused_misses,
            "launches": counts, "launches_by_shape": shapes_said(shapes),
            "launches_in_chain_matches": {
                "correlation_scores": chain_corr, "bad_ray_count": batches},
            "seconds": run_s, "loop_seconds": loop_s,
            "optimize_seconds": run_s - loop_s,
            "scans_per_s_fed": len(order) / loop_s, "scans_per_s_kept": kept / loop_s,
            "match_time_s": eng.diag.match_time_s,
            "backend_time_s": eng.diag.backend_time_s,
            "chain_match_s": eng.backend.chain_match_time_s,
            "solve_and_correct_s": eng.backend.solve_time_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        assert kept >= 20, f"kept {kept} scans"
        assert eng.backend.num_links > 0 and eng.backend.num_solves >= 1
        assert counts.pop("correlation_scores_v2") == 0, counts
        assert all(v > 0 for v in counts.values()), counts
        # three tiers per chain batch; one ray check per front-end step and
        # one per chain batch
        assert chain_corr == 3 * batches, chain_corr
        assert counts["bad_ray_count"] == len(order) + batches
        assert np.isfinite(traj).all() and traj.shape == (kept, 4)
        assert (pub_map == 100).any() and (pub_map == 0).any()
        return eng, report, shapes

    from roborts_slam_tpu_torch.backend import spa
    # leg 1: the shipped profile unchanged. This short log never leaves the
    # 7 m link radius, so the graph proposes no chain match here.
    engine, report, shapes1 = drive(config)
    emit({"phase": LEG1, **report, "spa_host_syncs": spa.host_syncs})
    account(LEG1, shapes1, ctx_sim)
    # what legs 1, 3 and 4 were fed and what they left, for jax_full_width
    fed1 = dict(laser=laser, ranges=ranges[order], odom=odom[order],
                times=np.asarray(feed_times), gt=None)
    jax_legs = {"leg1": (parity.leg_record(engine, fed1), parity.inputs_sha256(fed1))}
    kept = len(engine.store)
    # leg 2: the same run with the link radius cut to 1 m, so that the back
    # end proposes near chains and loop candidates by itself: chain matches
    # (B chains a call, 2432² maps), loop verification, SPA, map rebuilds.
    engine2, report2, shapes2 = drive(config.replace(link_scan_max_distance=1.0))
    emit({"phase": LEG2, "link_scan_max_distance": 1.0, **report2})
    assert report2["chain_dispatches"] + report2["fused_steps"] > 0, \
        "no chain match was proposed"
    account(LEG2, shapes2, ctx_sim)
    del engine2

    # where a kept scan's time can go: one SPA solve, one rebuild of all maps
    # after a correction, one B=4 chain match and the dilation inside it
    # (launch counts were read above; these repeats are not counted)
    last = kept - 1
    chains = [list(range(b, b + 10)) for b in range(0, 8, 2)]
    syncs0 = spa.host_syncs
    t1 = time.perf_counter()
    data = engine.backend.graph.as_solver_data(engine.store.poses_array(), dev)
    _, _, lm_iters = spa.solve_pose_graph(data)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    solve_syncs = spa.host_syncs - syncs0
    t1 = time.perf_counter()
    engine._apply_corrections(engine.store.poses_array())
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t1
    chain_ms = time_ms(lambda: engine.backend._match_chain_batch(
        chains, last, engine.store.poses[last].copy()), reps=10, warm=2, inner=2)
    bs = bspec.fine_spec
    img = (torch.rand((4, bs.height, bs.width), device=dev) > 0.999).float()
    dilate_ms = time_ms(lambda: raster.dilate_with_kernel(img, bs.blur_kernel()),
                        reps=10, warm=2, inner=2)
    emit({"phase": "breakdown", "spa_solve_seconds": solve_s,
          "spa_lm_iterations": lm_iters, "spa_host_syncs_per_solve": solve_syncs,
          "graph_nodes": int(data.poses.shape[0]), "graph_edges": int(data.edge_ij.shape[0]),
          "rebuild_all_maps_seconds": rebuild_s, "rebuild_scans": kept,
          "chain_match_b4_ms": chain_ms, "dilate_b4_2432_ms": dilate_ms,
          "frontend_ms_per_scan": engine.diag.match_time_s / len(order) * 1e3})
    del img, engine

    out_dir = profile_dir()
    if out_dir is not None:
        profile_frontend(SlamEngine, config, laser, ranges, odom, times, 30.0,
                         out_dir, "simulation")
        with corr_kernel(2):
            profile_frontend(SlamEngine, rr_config, loop_laser, loop_log.ranges,
                             loop_log.odom, loop_log.times, None, out_dir, "real_robot")
        profile_frontend(SlamEngine, df_config, loop_laser, loop_log.ranges,
                         loop_log.odom, loop_log.times, 40.0, out_dir, "default")
        # leg 5's engine against the blocking one over the same 300 scans
        # (chain matches, no closure yet), first kernel
        for sync in (True, False):
            profile_frontend(SlamEngine, rr_config, loop_laser, loop_log.ranges,
                             loop_log.odom, loop_log.times, None, out_dir,
                             f"real_robot_{'sync' if sync else 'async'}_300", n=305,
                             synchronous_backend=sync)
        profile_frontend(SlamEngine, rr_config, loop_laser, loop_log.ranges,
                         loop_log.odom, loop_log.times, None, out_dir,
                         "real_robot_pipelined_300", n=305, pipelined=True)

    # ---- phase 5: kernel path against plain path, end to end ----
    def replay(cfg, scan_laser, scan_log, world_size, device, n):
        """The first ``n`` scans through a new engine on ``device`` (None:
        the card, kernels; "cpu": the plain versions)."""
        reset_counts()
        eng = SlamEngine(cfg, scan_laser, world_size=world_size, device=device)
        sr, so, st = scan_log
        kept_ids = [i for i in range(n) if eng.process(sr[i], so[i], float(st[i]))]
        return kept_ids, eng.trajectory_array(), read_counts()

    def same_path(phase, a, b, **said):
        """Two replays kept the same scans and agree on every pose."""
        assert a[0] == b[0], (phase, a[0], b[0])
        d = np.abs(a[1] - b[1])
        d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
        emit({"phase": phase, **said, "kept": len(a[0]),
              "max_pos_diff_m": float(d[:, 1:3].max()),
              "max_ang_diff_rad": float(d[:, 3].max())})
        assert d[:, 1:3].max() <= POS_TOL and d[:, 3].max() <= ANG_TOL, (phase, d.max(0))

    willow_log = (ranges, odom, times)
    corridor_log = (loop_log.ranges, loop_log.odom, loop_log.times)
    on_card = replay(config, laser, willow_log, 30.0, None, 20)
    assert on_card[2]["correlation_scores"] > 0
    same_path("kernel_vs_plain_path", on_card,
              replay(config, laser, willow_log, 30.0, "cpu", 20),
              configuration="simulation", scans=20)

    def run_cli(argv, what, setup=None):
        """``python -m roborts_slam_tpu_torch`` with ``argv``, in-process.
        Returns the engine it built, a report (kernel launch counts of the
        run, set to 0 just before and read just after, and where the host's
        time went by the engine's own diagnostics) and the counts by shape.
        ``setup(engine)`` runs before the replay starts (the hooks)."""
        seen = {"engine": None}
        opt_costs = []

        def engine_seen(fn):
            def inner(self, source, *a, **kw):
                seen.update(engine=self, entry=f"{fn.__name__}({type(source).__name__})")
                if setup is not None:
                    setup(self)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(self, source, *a, **kw)
                torch.cuda.synchronize()
                seen["replay_s"] = time.perf_counter() - t
                return out
            return inner

        def costs_kept(fn):
            def inner(*a, **kw):
                res = fn(*a, **kw)
                if res.cost.dim() == 0:          # the front end's single match
                    opt_costs.append(res.cost)
                return res
            return inner

        said = io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(SlamEngine, "run_log", engine_seen))
            stack.enter_context(patched(SlamEngine, "run_stream", engine_seen))
            stack.enter_context(patched(matchers, "optimize_scan_match", costs_kept))
            stack.enter_context(contextlib.redirect_stdout(said))
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            counts, shapes = read_counts(), read_shapes()
        assert rc == 0, f"{what}: run returned {rc}"
        eng = seen["engine"]
        diag, back = eng.diag, eng.backend
        traj = eng.trajectory_array()
        assert np.isfinite(traj).all() and traj.shape == (len(eng.store), 4)
        est, gt = match_by_time(traj, loop_log.gt_poses, loop_log.times)
        last = said.getvalue().strip().splitlines()[-2:]
        front_steps = diag.scans_in - diag.scans_dropped_move
        batches = back.num_chain_dispatches + diag.fused_steps
        chain_corr = on_maps_of(shapes, correlation.kernel_version(), eng.bspec.fine_spec) \
            if batches else 0
        report = {
            "argv": [a if not a.startswith(tmp.name) else os.path.basename(a) for a in argv],
            "scans_fed": diag.scans_in, "kept": len(eng.store),
            "dropped_by_move_gate": diag.scans_dropped_move,
            "dropped_by_score_gate": diag.scans_dropped_gate,
            "links": back.num_links,
            "loop_closures": back.num_loop_closures,
            "spa_solves": back.num_solves,
            "chain_dispatches": back.num_chain_dispatches,
            "fused_steps": diag.fused_steps, "fused_hits": back.num_fused_hits,
            "fused_misses": back.num_fused_misses,
            # one read of the step's summary (and the chain rows of a fused
            # step) per front-end step, one per separate chain batch; the SPA
            # solve's reads apart
            "host_reads_per_kept_scan": (front_steps + back.num_chain_dispatches)
            / len(eng.store),
            "recenters": diag.recenters, "dedistorted_scans": diag.scans_dedistorted,
            "ate_rmse_m": ate_rmse(est, gt), "cli_said": last,
            "fine_map": [eng.fspec.fine_spec.height, eng.fspec.fine_spec.width],
            "chain_map": [eng.bspec.fine_spec.height, eng.bspec.fine_spec.width],
            "pub_map": [eng.fspec.pub_spec.height, eng.fspec.pub_spec.width],
            "launches": counts, "launches_by_shape": shapes_said(shapes),
            "launches_in_chain_matches": {"correlation": chain_corr, "bad_ray_count": batches},
            "entry": seen["entry"], "synchronous_backend": eng.synchronous_backend,
            "seconds": seconds, "ms_per_scan_fed": seconds / diag.scans_in * 1e3,
            # the replay alone (first scan to finish(), the worker joined):
            # no log loading, engine set-up or output writing
            "replay_s": seen["replay_s"],
            "replay_ms_per_scan_fed": seen["replay_s"] / diag.scans_in * 1e3,
            "frontend_s": diag.match_time_s, "backend_s": diag.backend_time_s,
            "backend_batches": diag.backend_batches,
            "backend_batch_max": diag.backend_batch_max,
            "stages": eng.timers.as_dict(),
            "dedistort_s": diag.dedistort_time_s, "recenter_s": diag.recenter_time_s,
            "chain_match_s": back.chain_match_time_s,
            "solve_and_correct_s": back.solve_time_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        assert counts["bad_ray_count"] == front_steps + batches, counts
        if opt_costs:
            failed = int((torch.stack(opt_costs)
                          > eng.config.optimize_failed_cost).sum())
            report["optimizer_pose_taken"] = len(opt_costs) - failed
            report["fell_back_to_coarse_tier"] = failed
        return eng, report, shapes

    # ---- phase 7 (leg 3): the real-robot profile through ``run`` ----
    with corr_kernel(2):
        eng3, report3, shapes3 = run_cli(
            ["run", log_path, "--config", str(ROOT / "configs" / "real_robot.yaml")],
            "leg 3")
    emit({"phase": LEG3, "corr_kernel": 2, **report3})
    assert eng3.config == rr_config and eng3.fspec.fine_spec == rr_fspec.fine_spec
    c3 = report3["launches"]
    assert c3["correlation_scores"] == 0, "leg 3 launched the first kernel"
    assert min(c3["correlation_scores_v2"], c3["ray_mark_image"], c3["bad_ray_count"]) > 0, c3
    batches3 = report3["chain_dispatches"] + report3["fused_steps"]
    assert batches3 > 0 and report3["fused_steps"] > 0, "no fused chain batch"
    assert report3["launches_in_chain_matches"]["correlation"] == 3 * batches3, \
        report3["launches_in_chain_matches"]
    assert report3["recenters"] >= 3, report3["recenters"]
    fed = report3["scans_fed"] - report3["dropped_by_move_gate"]
    assert report3["dedistorted_scans"] == fed - 1, (report3["dedistorted_scans"], fed)
    assert report3["loop_closures"] >= 1, "no loop was closed at the shipped link radius"
    assert report3["ate_rmse_m"] < ATE_BAR_M, report3["ate_rmse_m"]
    pub3 = eng3.get_pub_map()
    assert (pub3 == 100).any() and (pub3 == 0).any()
    account(LEG3, shapes3, ctx_rr)
    fed3 = parity.leg_inputs("leg3", loop_log)
    jax_legs["leg3"] = (parity.leg_record(eng3, fed3, parity.port_ate),
                        parity.inputs_sha256(fed3))
    traj3 = eng3.trajectory_array()
    graph3 = sorted((e.source, e.target) for e in eng3.backend.graph.edges)

    # ---- phases 7a-c: parallel/ on leg 3's state (first kernel) ----
    parallel_phases(eng3, rr_config, rr_fspec, rr_bspec, dev, types.SimpleNamespace(
        reset_counts=reset_counts, read_counts=read_counts, read_shapes=read_shapes,
        shapes_said=shapes_said, account=account, relist=relist_rr_k1, ctx=ctx_rr1))
    del eng3

    # ---- phase 7b: leg 3's log and profile through the API in the JAX
    # engine's other two modes, against leg 3 (fused, blocking) ----
    dispatches = {"all": 0, "steady": 0, "steady_syncs": 0, "where": Counter(),
                  "other_where": Counter()}

    def syncs_of(fn, *a, **kw):
        """``fn(*a, **kw)`` with the implicit synchronisations of the CUDA
        calls it makes reported (``set_sync_debug_mode("warn")``). Returns
        its result and where each was called, as "file:line"."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                     if "synchroniz" in str(w.message)]

    # the counter sees a synchronisation where there is one: a host read,
    # and a copy from pageable host memory
    _, seen = syncs_of(lambda: (torch.ones(3, device=dev).sum().item(),
                                torch.as_tensor(np.ones(3, np.float32), device=dev)))
    assert len(seen) >= 2, seen

    def syncs_counted(fn):
        """``_dispatch_pipelined`` with its implicit synchronisations counted;
        a dispatch is steady when the pipeline is full (no drain before it)."""
        def inner(self, *a, **kw):
            steady = len(self._inflight) == self.pipeline_depth
            out, where = syncs_of(fn, self, *a, **kw)
            dispatches["all"] += 1
            if steady:
                dispatches["steady"] += 1
                dispatches["steady_syncs"] += len(where)
            dispatches["where" if steady else "other_where"].update(where)
            return out
        return inner

    def replay_api(**kw):
        """Leg 3's log through ``SlamEngine.process`` under the real-robot
        profile with the second kernel; ``pipelined``: the pipelined fetch,
        depth 3. Counts set to 0 just before, read just after."""
        pipelined = kw.pop("pipelined", False)
        with corr_kernel(2), contextlib.ExitStack() as stack:
            if pipelined:
                stack.enter_context(patched(SlamEngine, "_dispatch_pipelined",
                                            syncs_counted))
            eng = SlamEngine(rr_config, loop_laser, **kw)
            eng.pipelined_fetch, eng.pipeline_depth = pipelined, 3
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(len(loop_log)):
                eng.process(loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i]))
            eng.finish()
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t
            counts, shapes = read_counts(), read_shapes()
        back, diag = eng.backend, eng.diag
        report = {
            "scans_fed": diag.scans_in, "kept": len(eng.store), "links": back.num_links,
            "loop_closures": back.num_loop_closures, "spa_solves": back.num_solves,
            "chain_dispatches": back.num_chain_dispatches, "fused_steps": diag.fused_steps,
            "fused_hits": back.num_fused_hits, "fused_misses": back.num_fused_misses,
            "dropped_by_move_gate": diag.scans_dropped_move,
            "dropped_by_score_gate": diag.scans_dropped_gate,
            "replay_s": replay_s, "replay_ms_per_scan_fed": replay_s / diag.scans_in * 1e3,
            "launches": counts, "launches_by_shape": shapes_said(shapes),
            "stages": eng.timers.as_dict()}
        return eng, report, shapes

    def against_leg3(phase, eng, report, tol, **said):
        """The same kept scans, links and closures as leg 3, within ``tol``."""
        traj = eng.trajectory_array()
        same = traj.shape == traj3.shape and np.array_equal(traj[:, 0], traj3[:, 0])
        d = np.abs(traj - traj3) if same else np.full((1, 4), np.inf)
        d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
        emit({"phase": phase, **report, **said, "same_kept_ids_as_leg_3": bool(same),
              "leg3": {k: report3[k] for k in (
                  "kept", "links", "loop_closures", "chain_dispatches", "fused_steps",
                  "fused_hits", "fused_misses", "replay_ms_per_scan_fed",
                  "host_reads_per_kept_scan")},
              "max_pos_diff_m": float(d[:, 1:3].max()),
              "max_ang_diff_rad": float(d[:, 3].max())})
        assert same, f"{phase}: other kept scans than leg 3"
        assert (report["links"], report["loop_closures"]) == \
            (report3["links"], report3["loop_closures"]), phase
        assert sorted((e.source, e.target) for e in eng.backend.graph.edges) == graph3, phase
        assert d[:, 1:3].max() <= tol and d[:, 3].max() <= tol, (phase, d.max(0))

    eng_u, report_u, shapes_u = replay_api(fused_backend=False)
    assert report_u["fused_steps"] == 0
    front_u = report_u["scans_fed"] - report_u["dropped_by_move_gate"]
    report_u["host_reads_per_kept_scan"] = (front_u + report_u["chain_dispatches"]) \
        / report_u["kept"]
    assert report_u["launches"]["bad_ray_count"] == front_u + report_u["chain_dispatches"]
    against_leg3("fused_vs_unfused", eng_u, report_u, 1e-5, fused_backend=False)
    assert report3["chain_dispatches"] < report_u["chain_dispatches"], \
        (report3["chain_dispatches"], report_u["chain_dispatches"])
    account("fused_vs_unfused", shapes_u, ctx_rr)
    del eng_u

    eng_p, report_p, shapes_p = replay_api(pipelined=True)
    assert not eng_p._inflight and report_p["fused_steps"] > 0
    steps_p = dispatches["all"] + 1                   # the first scan is blocking
    batches_p = report_p["chain_dispatches"] + report_p["fused_steps"]
    assert report_p["launches"]["bad_ray_count"] == steps_p + batches_p, report_p["launches"]
    report_p.update(
        pipeline_depth=3, dispatches=dispatches["all"],
        steady_dispatches=dispatches["steady"],
        implicit_syncs_per_steady_dispatch=dispatches["steady_syncs"]
        / max(dispatches["steady"], 1),
        implicit_syncs_where=dict(dispatches["where"].most_common()),
        implicit_syncs_in_other_dispatches=dict(dispatches["other_where"].most_common()),
        sync_counter_saw=seen,
        host_reads_per_kept_scan=(steps_p + report_p["chain_dispatches"]) / report_p["kept"])
    pub_p = eng_p.get_pub_map()
    report_p["pub_map_cells_differing_from_leg_3"] = int((pub_p != pub3).sum()) \
        if pub_p.shape == pub3.shape else -1
    against_leg3("pipelined_vs_blocking", eng_p, report_p, 1e-4)
    assert report_p["pub_map_cells_differing_from_leg_3"] == 0, "pub maps differ"
    assert (report_p["dropped_by_move_gate"], report_p["dropped_by_score_gate"]) == \
        (report3["dropped_by_move_gate"], report3["dropped_by_score_gate"])
    n_p = len(eng_p.store)
    dpts, dmsk, dposes = eng_p.store.device_arrays()
    assert np.array_equal(dpts[:n_p].cpu().numpy(), np.stack(eng_p.store._points))
    assert np.array_equal(dmsk[:n_p].cpu().numpy(), np.stack(eng_p.store._masks))
    assert np.array_equal(dposes[:n_p].cpu().numpy(),
                          eng_p.store.poses_array().astype(np.float32))
    traj_p = eng_p.trajectory_array()
    account("pipelined_vs_blocking", shapes_p, ctx_rr)
    del eng_p, dpts, dmsk, dposes, pub_p

    # the three modes timed in turns over leg 3's whole log (a third of its
    # fused steps fall on scans the gate rejects): fused, unfused, pipelined,
    # then back; the host's clock, no counter or sync check on
    modes = {"fused": (True, False), "unfused": (False, False), "pipelined": (True, True)}
    runs = {m: [] for m in modes}
    stages = {m: [] for m in modes}
    for m in ("fused", "unfused", "pipelined", "pipelined", "unfused", "fused"):
        with corr_kernel(2):
            fused, pipelined = modes[m]
            eng = SlamEngine(rr_config, loop_laser, fused_backend=fused)
            eng.pipelined_fetch = pipelined
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(len(loop_log)):
                eng.process(loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i]))
            eng.finish()
            torch.cuda.synchronize()
            runs[m].append((time.perf_counter() - t) / len(loop_log) * 1e3)
            stages[m].append({k: v["total_s"] for k, v in eng.timers.as_dict().items()})
            assert len(eng.store) == report3["kept"], (m, len(eng.store))
        del eng
    emit({"phase": "modes_in_turns", "scans": len(loop_log), "corr_kernel": 2,
          "order": "fused, unfused, pipelined, pipelined, unfused, fused",
          "replay_ms_per_scan_fed": runs, "stage_seconds": stages,
          "mean_ms_per_scan_fed": {m: statistics.mean(v) for m, v in runs.items()}})

    # ---- phase 8: the real-robot profile's paths against each other: second
    # kernel, first kernel (60 scans) and the plain versions (40 scans, past
    # the first recenter) ----
    def replay_rr(version, device, n):
        with corr_kernel(version):
            return replay(rr_config, loop_laser, corridor_log, None, device, n)

    rr_2, rr_1 = replay_rr(2, None, 60), replay_rr(1, None, 60)
    assert rr_2[2]["correlation_scores"] == 0 < rr_2[2]["correlation_scores_v2"]
    assert rr_1[2]["correlation_scores_v2"] == 0 < rr_1[2]["correlation_scores"]
    same_path("kernel_2_vs_kernel_1_path", rr_2, rr_1, scans=60)
    same_path("kernel_vs_plain_path_real_robot", replay_rr(2, None, 40),
              replay_rr(2, "cpu", 40), configuration="real_robot", scans=40)

    # ---- phase 9 (leg 4): the default configuration through ``run`` ----
    common = ["--max-points", "1152", "--world-size", "40"]
    eng4, report4, shapes4 = run_cli(["run", head_log(200), *common], "leg 4")
    emit({"phase": LEG4, **report4})
    assert eng4.config == df_config and eng4.config.use_optimize_scan_match \
        and eng4.config.match_map_window == 0
    assert eng4.fspec.fine_spec == df_fspec.fine_spec, "not the full width"
    assert report4["kept"] >= 150, report4["kept"]
    assert report4["optimizer_pose_taken"] + report4["fell_back_to_coarse_tier"] \
        == report4["scans_fed"]
    assert report4["launches"]["correlation_scores"] > 0
    account(LEG4, shapes4, ctx_df)
    fed4 = parity.leg_inputs("leg4", loop_log)
    jax_legs["leg4"] = (parity.leg_record(eng4, fed4, parity.port_ate),
                        parity.inputs_sha256(fed4))
    del eng4

    # ---- phase 9a: legs 1, 3 and 4 against the JAX package's own results
    # on the same inputs at full width (tests/data/jax_full_width.npz, written
    # on the CPU by scripts/torch_full_width_parity.py --write) ----
    fixture = parity.load_fixture()
    legs_said, failed = {}, {}
    for leg, (rec, sha) in jax_legs.items():
        legs_said[leg], bars = parity.compare_leg(rec, fixture[leg], sha)
        if bars:
            failed[leg] = bars
    emit({"phase": "jax_full_width", "fixture": str(parity.FIXTURE.relative_to(ROOT)),
          "legs": legs_said, "failed": failed})
    assert not failed, failed
    same_path("kernel_vs_plain_path_default_config",
              replay(df_config, loop_laser, corridor_log, 40.0, None, 20),
              replay(df_config, loop_laser, corridor_log, 40.0, "cpu", 20),
              configuration="default", scans=20)

    # ---- phase 9b: the card's steps one at a time against the plain path:
    # before each scan the CPU plain engine's whole state is carried to the
    # card, both take the scan, the card's step is held at the per-step bars
    # of bench/parity.py, and each kernel launch of the card's step against
    # its plain version on the same inputs ----
    emit({"phase": LOCKSTEP, "device": smi, **lockstep_phase(
        SlamEngine, dev, [
            ("leg1", config, laser, 30.0, 1,
             [("process", (ranges[i], odom[i], feed_times[k]))
              for k, i in enumerate(order[:20])]),
            ("leg3", rr_config, loop_laser, None, 2,
             [("process", (loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i])))
              for i in range(60)])])})
    # each remaining matcher option once on the card, 40 scans each; their
    # launches are held to the compared shapes, and listed under leg 4's
    for flag in ("use_fast_correlation_match", "use_running_range_scan_match"):
        cfg_path = os.path.join(tmp.name, f"{flag}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({flag: True}, f)
        eng_s, report_s, shapes_s = run_cli(
            ["run", head_log(40), "--config", cfg_path, *common], flag)
        emit({"phase": f"short_leg_{flag}", **report_s})
        assert getattr(eng_s.config, flag) and report_s["kept"] >= 30, report_s["kept"]
        account(f"short_leg_{flag}", shapes_s, ctx_df)
        del eng_s

    # ---- phase 10 (leg 5): the online engine through ``run --async`` ----
    from roborts_slam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from roborts_slam_tpu_torch.io.native_log import write_rslg
    from roborts_slam_tpu_torch.io.rosbag import bag_to_scan_log, write_bag

    rr_yaml = str(ROOT / "configs" / "real_robot.yaml")
    rslg_path = os.path.join(tmp.name, "corridor_loop.rslg")
    write_rslg(loop_log, rslg_path)
    out_map = os.path.join(tmp.name, "map")
    end_ckpt = os.path.join(tmp.name, "end.npz")
    hooks = {"poses": 0, "snapshots": [], "samples": [], "t0": None}

    def set_hooks(eng):
        """``on_pose`` samples the pose stream at 100 Hz of log time up to
        each kept scan's stamp; ``on_map_snapshot`` every 50 kept scans."""
        def on_pose(t, pose):
            hooks["poses"] += 1
            if hooks["t0"] is None:
                hooks["t0"] = t
            while True:
                ts = hooks["t0"] + STREAM_DT * len(hooks["samples"])
                if ts > t + 1e-9:
                    break
                hooks["samples"].append(eng.pose_at(ts))

        def on_map_snapshot(n, grid):
            hooks["snapshots"].append(np.unique(grid).tolist())

        eng.on_pose, eng.on_map_snapshot = on_pose, on_map_snapshot
        eng.map_snapshot_every = SNAPSHOT_EVERY

    # the carve and ray-check entries of the real-robot shapes, and the first
    # kernel's correlation entries there, listed again for leg 5's launches
    # (the worker's chain batch sizes vary with its drains)
    relist_rr_k1(LEG5, ("corr", "mark", "check"),
                 lambda key: key in optional or "chain_b" in key)
    with corr_kernel(1):
        eng5, report5, shapes5 = run_cli(
            ["run", rslg_path, "--config", rr_yaml, "--async", "--out-map", out_map,
             "--checkpoint", end_ckpt], "leg 5", setup=set_hooks)
    samples = np.asarray(hooks["samples"])
    t_kept = eng5.trajectory_array()[:, 0]
    report5.update(
        pose_stream={"hz": 1 / STREAM_DT, "samples": len(samples),
                     "span_s": float(t_kept[-1] - t_kept[0]),
                     "all_finite": bool(np.isfinite(samples).all())},
        on_pose_calls=hooks["poses"], map_snapshots=len(hooks["snapshots"]),
        map_snapshot_values=sorted({v for vs in hooks["snapshots"] for v in vs}),
        leg3_ate_rmse_m=report3["ate_rmse_m"],
        leg3_replay_ms_per_scan_fed=report3["replay_ms_per_scan_fed"],
        worker_share_of_replay=report5["backend_s"] / report5["replay_s"])
    emit({"phase": LEG5, "corr_kernel": 1, **report5})
    assert report5["entry"] == "run_stream(NativeScanStream)", report5["entry"]
    assert not eng5.synchronous_backend and eng5._backend_thread is None
    assert eng5.config == rr_config and eng5.fspec.fine_spec == rr_fspec.fine_spec
    c5 = report5["launches"]
    assert c5["correlation_scores_v2"] == 0, "leg 5 launched the second kernel"
    assert min(c5["correlation_scores"], c5["ray_mark_image"], c5["bad_ray_count"]) > 0, c5
    batches5 = report5["chain_dispatches"] + report5["fused_steps"]
    assert batches5 > 0 and report5["launches_in_chain_matches"]["correlation"] \
        == 3 * batches5, report5["launches_in_chain_matches"]
    # the JAX package's bar for its asynchronous fused engine
    # (tests/test_engine_features.py:641-647): the worker takes the chain
    # rows from its queue; separate batches only on misses and corrections
    assert report5["fused_steps"] > 0 and report5["fused_hits"] > 0, report5
    assert report5["chain_dispatches"] <= report5["fused_misses"] + report5["spa_solves"] + 4, \
        (report5["chain_dispatches"], report5["fused_misses"], report5["spa_solves"])
    assert report5["loop_closures"] >= 1, "leg 5 closed no loop"
    assert report5["ate_rmse_m"] <= max(2 * report3["ate_rmse_m"], 0.15), report5["ate_rmse_m"]
    kept5 = report5["kept"]
    assert hooks["poses"] == kept5 and len(hooks["snapshots"]) == kept5 // SNAPSHOT_EVERY
    assert set(report5["map_snapshot_values"]) <= {-1, 0, 100}
    assert len(samples) == int(np.floor((t_kept[-1] - t_kept[0]) / STREAM_DT + 1e-6)) + 1
    assert report5["pose_stream"]["all_finite"]
    # after finish(): trajectory, host store, device mirror and the worker's
    # pub snapshot agree
    assert np.array_equal(eng5.trajectory_array()[:, 1:], eng5.store.poses_array())
    n5 = len(eng5.store)
    dpts, dmsk, dposes = eng5.store.device_arrays()
    assert np.array_equal(dpts[:n5].cpu().numpy(), np.stack(eng5.store._points))
    assert np.array_equal(dmsk[:n5].cpu().numpy(), np.stack(eng5.store._masks))
    assert np.array_equal(dposes[:n5].cpu().numpy(),
                          eng5.store.poses_array().astype(np.float32))
    pub_spec5, hits5, passes5, off5 = eng5.store.pub_map_arrays()
    live = eng5.state.pub
    assert hits5.data_ptr() != live.hits.data_ptr() and passes5.data_ptr() != live.passes.data_ptr()
    assert torch.equal(hits5, live.hits) and torch.equal(passes5, live.passes) \
        and torch.equal(off5, live.offset) and pub_spec5 == eng5.fspec.pub_spec
    with open(out_map + ".pgm", "rb") as f:
        assert f.read(2) == b"P5"
    back = load_checkpoint(end_ckpt)
    assert np.array_equal(back.store.poses_array(), eng5.store.poses_array())
    assert torch.equal(back.state.pub.hits, live.hits)
    del back, eng5, live, hits5, passes5, dpts, dmsk, dposes
    account(LEG5, shapes5, ctx_rr1)

    # ---- phase 11: checkpoint and resume against leg 3's straight run ----
    half = len(loop_log) // 2
    reset_counts()
    t1 = time.perf_counter()
    with corr_kernel(2):
        part = SlamEngine(rr_config, loop_laser)
        for i in range(half):
            part.process(loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i]))
        ckpt = os.path.join(tmp.name, "half.npz")
        t2 = time.perf_counter()
        save_checkpoint(part, ckpt)
        save_s = time.perf_counter() - t2
        t2 = time.perf_counter()
        resumed = load_checkpoint(ckpt)
        load_s = time.perf_counter() - t2
        assert len(resumed.store) == len(part.store) and resumed.device == part.device
        del part
        for i in range(half, len(loop_log)):
            resumed.process(loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i]))
        resumed.finish()
    torch.cuda.synchronize()
    shapes_cr = read_shapes()
    traj_cr = resumed.trajectory_array()
    same_ids = traj_cr.shape == traj3.shape and np.array_equal(traj_cr[:, 0], traj3[:, 0])
    if same_ids:
        d = np.abs(traj_cr - traj3)
        d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    else:       # where the kept ids part: the first stamp kept by one run only
        d = np.full((1, 4), np.inf)
        parted = sorted(set(traj_cr[:, 0]) ^ set(traj3[:, 0]))[:1]
    emit({"phase": "checkpoint_resume", "corr_kernel": 2, "scans_before_save": half,
          "same_kept_ids_as_leg_3": bool(same_ids),
          **({} if same_ids else {"kept_by_one_run_only_from_t": parted}),
          "scans_after_load": len(loop_log) - half, "kept": len(traj_cr),
          "loop_closures": resumed.backend.num_loop_closures,
          "max_pos_diff_m": float(d[:, 1:3].max()), "max_ang_diff_rad": float(d[:, 3].max()),
          "save_s": save_s, "load_s": load_s, "checkpoint_bytes": os.path.getsize(ckpt),
          "seconds": time.perf_counter() - t1, "launches": read_counts(),
          "launches_by_shape": shapes_said(shapes_cr)})
    assert same_ids, "the resumed run kept other scans than leg 3"
    assert d[:, 1:3].max() <= POS_TOL and d[:, 3].max() <= ANG_TOL, d.max(0)
    del resumed
    account("checkpoint_resume", shapes_cr, ctx_rr)

    # the same under the pipelined fetch, against the straight pipelined run
    reset_counts()
    t1 = time.perf_counter()
    with corr_kernel(2):
        part = SlamEngine(rr_config, loop_laser)
        part.pipelined_fetch = True
        for i in range(half):
            part.process(loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i]))
        save_checkpoint(part, ckpt)                  # drains the scans in flight
        assert not part._inflight
        del part
        resumed = load_checkpoint(ckpt)
        resumed.pipelined_fetch = True
        for i in range(half, len(loop_log)):
            resumed.process(loop_log.ranges[i], loop_log.odom[i], float(loop_log.times[i]))
        resumed.finish()
    torch.cuda.synchronize()
    shapes_cp = read_shapes()
    traj_cp = resumed.trajectory_array()
    same_ids = traj_cp.shape == traj_p.shape and np.array_equal(traj_cp[:, 0], traj_p[:, 0])
    d = np.abs(traj_cp - traj_p) if same_ids else np.full((1, 4), np.inf)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    emit({"phase": "checkpoint_resume_pipelined", "corr_kernel": 2,
          "scans_before_save": half, "same_kept_ids_as_pipelined_run": bool(same_ids),
          "kept": len(traj_cp), "fused_steps": resumed.diag.fused_steps,
          "loop_closures": resumed.backend.num_loop_closures,
          "max_pos_diff_m": float(d[:, 1:3].max()), "max_ang_diff_rad": float(d[:, 3].max()),
          "seconds": time.perf_counter() - t1, "launches": read_counts(),
          "launches_by_shape": shapes_said(shapes_cp)})
    assert same_ids, "the resumed pipelined run kept other scans"
    assert d[:, 1:3].max() <= 1e-4 and d[:, 3].max() <= 1e-4, d.max(0)
    del resumed
    account("checkpoint_resume_pipelined", shapes_cp, ctx_rr)

    # ---- phase 12: the first 120 scans as a bz2-chunked .bag and as .npz ----
    bag_path = os.path.join(tmp.name, "corridor_loop.bag")
    n_bag = 120
    write_bag(bag_path, ScanLog(loop_log.ranges[:n_bag], loop_log.odom[:n_bag],
                                loop_log.times[:n_bag], loop_laser),
              compression="bz2", chunk_msgs=64)
    read = bag_to_scan_log(bag_path)
    assert np.array_equal(read.ranges, loop_log.ranges[:n_bag])
    odom_err = float(np.abs(read.odom - loop_log.odom[:n_bag]).max())
    time_err = float(np.abs(read.times - loop_log.times[:n_bag]).max())
    assert odom_err <= 1e-9 and time_err <= 1e-9, (odom_err, time_err)
    with corr_kernel(1):
        runs = {kind: run_cli(["run", path, "--config", rr_yaml], f"bag_vs_npz {kind}")
                for kind, path in (("bag", bag_path), ("npz", head_log(n_bag)))}
    (eb, rb, sb), (en, rn, sn) = runs["bag"], runs["npz"]
    tb, tn = eb.trajectory_array(), en.trajectory_array()
    assert tb.shape == tn.shape and np.abs(tb[:, 0] - tn[:, 0]).max() <= 1e-9, \
        "the .bag run kept other scans"
    d = np.abs(tb - tn)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    emit({"phase": "bag_vs_npz", "scans": n_bag, "compression": "bz2", "chunk_msgs": 64,
          "bag_bytes": os.path.getsize(bag_path), "ranges_exact": True,
          "odom_max_abs_err": odom_err, "times_max_abs_err_s": time_err,
          "kept": len(tb), "max_pos_diff_m": float(d[:, 1:3].max()),
          "max_ang_diff_rad": float(d[:, 3].max()),
          "bag": {k: rb[k] for k in ("entry", "replay_s", "launches", "launches_by_shape")},
          "npz": {k: rn[k] for k in ("entry", "replay_s", "launches")}})
    assert d[:, 1:3].max() <= POS_TOL and d[:, 3].max() <= ANG_TOL, d.max(0)
    account("bag_vs_npz bag", sb, ctx_rr1)
    account("bag_vs_npz npz", sn, ctx_rr1)
    del eb, en, runs
    tmp.cleanup()
    torch.cuda.empty_cache()

    # ---- phase 13: the headline benchmark, ``python -m roborts_slam_tpu_torch
    # bench`` (bench/headline.py): K1 and K2 held against the plain version at
    # its three tier shapes, then the benchmark with each, in turns ----
    from roborts_slam_tpu_torch.bench import headline as bench
    from roborts_slam_tpu_torch.bench.workload import headline_workload
    from roborts_slam_tpu_torch.frontend.matchers import scan_match

    t1 = time.perf_counter()
    BENCH = "bench_headline"
    hw = headline_workload(device=dev)
    hm = hw["matcher"]
    corr_entries(hw["fine_spec"], {"coarse": hm.coarse, "fine": hm.fine,
                                   "super_fine": hm.super_fine},
                 hw["fine_probs"], hw["offset"], hw["init_pose"], hw["points"],
                 hw["n_valid"], "bench_b1", K1, BENCH)
    for e in both_kernels:          # the second kernel's rows, listed too
        if e["name"].startswith(K2["name"] + "[bench_b1:"):
            key = e["name"][len(K2["name"]) + 1:-1] + "@k2"
            entries[key] = {k: v for k, v in e.items() if k != "max_abs_k2_minus_k1"}
            counted_as[key] = ("corr", 2, *e["shape"])
    # one match on the card against the plain path on the CPU
    hw_cpu = headline_workload(device="cpu")
    match_args = lambda w: (w["matcher"], w["fine_spec"], w["fine_probs"], w["offset"],
                            w["coarse_spec"], w["coarse_probs"], w["coff"], w["points"],
                            w["mask"], w["n_valid"], w["init_pose"])
    got, want = scan_match(*match_args(hw)), scan_match(*match_args(hw_cpu))
    match_diff = {"pose": float((got.pose.cpu() - want.pose).abs().max()),
                  "score": float((got.score.cpu() - want.score).abs())}
    assert match_diff["pose"] <= POS_TOL and match_diff["score"] <= 1e-5, match_diff
    del hw_cpu
    baseline = bench.cpu_baseline_scans_per_sec()
    reset_counts()
    records = []
    for version in (1, 2, 2, 1):
        with corr_kernel(version):
            records.append(bench.headline(device=dev, baseline=baseline))
    counts, shapes = read_counts(), read_shapes()
    k1, k2 = bench.K_POINTS
    matches = 2 * (k1 + (1 + bench.REPS) * (k1 + k2))    # per kernel: two runs
    for r in records:
        assert r["device"] == torch.cuda.get_device_name(0) and r["value"] > 0, r
        assert all(np.isfinite(r[k]) for k in ("value", "match_us", "vs_baseline",
                                                "hbm_frac_of_peak", "gops_per_s")), r
    by_kernel = {v: [r for r in records if r["corr_kernel"] == v] for v in (1, 2)}
    report_b = {
        "timed": "K slope at K = %s, best of %d reps per K point, each run's "
                 "workload made anew; the kernels in turns (1, 2, 2, 1)"
                 % (list(bench.K_POINTS), bench.REPS),
        "map": [hw["fine_spec"].height, hw["fine_spec"].width],
        "tiers": {t: [p.n_angles, p.max_samples, p.n_space] for t, p in
                  (("coarse", hm.coarse), ("fine", hm.fine), ("super_fine", hm.super_fine))},
        "kernel_rows": [{k: v for k, v in e.items() if k != "box"} for e in both_kernels
                        if "[bench_b1:" in e["name"]],
        "card_vs_cpu_plain_one_match": match_diff,
        "baseline_scans_per_sec": baseline,
        "runs": records,
        "mean": {f"k{v}": {k: statistics.mean(r[k] for r in rs)
                           for k in ("value", "match_us", "vs_baseline", "achieved_gbps",
                                     "hbm_frac_of_peak", "gops_per_s")}
                 for v, rs in by_kernel.items()},
        "bound_us": records[0]["bound_us"], "bound_by": records[0]["bound_by"],
        "kernel_launches_per_match": {name: n / matches for name, n in counts.items()},
        "launches": counts, "launches_by_shape": shapes_said(shapes)}
    assert report_b["kernel_launches_per_match"]["correlation_scores"] == 3.0
    assert report_b["kernel_launches_per_match"]["correlation_scores_v2"] == 3.0
    account(BENCH, shapes, None)
    if out_dir is not None:
        for version in (1, 2):
            with corr_kernel(version):
                report_b[f"profile_k{version}"] = profile_matches(
                    bench.match_chain(hw), 20, out_dir, f"bench_headline_k{version}")
    emit({"phase": BENCH, **report_b, "seconds": time.perf_counter() - t1})
    del hw
    torch.cuda.empty_cache()

    # every kernel of every main path was launched on it, at a compared shape
    listed = [e for e in entries.values() if e["launches"] > 0]
    on_leg = {LEG1: ("correlation_scores[", "ray_mark_image[", "bad_ray_count["),
              LEG2: ("correlation_scores[chain",),
              LEG3: ("correlation_scores_v2[", "ray_mark_image[", "bad_ray_count["),
              LEG4: ("correlation_scores[", "ray_mark_image[", "bad_ray_count["),
              LEG5: ("correlation_scores[", "ray_mark_image[", "bad_ray_count["),
              "parallel_chain_match": ("correlation_scores[", "bad_ray_count["),
              "log_odds": ("ray_mark_image[",),
              BENCH: ("correlation_scores[", "correlation_scores_v2[")}
    for leg, names in on_leg.items():
        for name in names:
            assert any(e["launches_from"] == leg and e["name"].startswith(name)
                       for e in listed), f"{name}...]: no launch listed for {leg}"
    emit({"kernels": listed})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
