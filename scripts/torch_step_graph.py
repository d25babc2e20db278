#!/usr/bin/env python3
"""The per-scan step replayed from CUDA graphs against the same step launched
eagerly, on the card.

    python3 scripts/torch_step_graph.py [--root DIR] [--legs LIST] [--scans N]
                                       [--runs R] [--profile N] [--headline K]

For each leg (``leg1``: ``configs/simulation.yaml`` on the willow
out-and-back, 1152 points, 30 m world; ``leg3``: ``configs/real_robot.yaml``
on the corridor-loop log with the second correlation kernel; ``leg4``: the
default ``SlamConfig()`` on that log at 40 m; ``leg3_pipelined``: leg 3's
engine with the pipelined fetch; ``leg3_async``: with the back end on its
worker thread and the first kernel, as leg 5 runs it, its time taken to the
worker's join, where the record also gives the worker's lag at the fused
steps: kept scans not yet in its graph, min / median / max) the first
``--scans`` scans go through an
engine whose steps replay CUDA graphs and through one that launches them
eagerly (``step_graph=False``), in turns, ``--runs`` times each: per run the
milliseconds per fed scan, the kept count, captures and replays by program,
and whether the two engines' per-step summaries, trajectories, maps and store
rows are equal bit for bit. ``--profile N``: the last N scans of each engine
under ``torch.profiler``: launch calls on the host per scan (kernel launches,
graph launches, copies), device kernels and busy time per scan, and the
device's idle share of the same N scans' unprofiled wall. ``--headline K``: the
headline's chained match (``bench/headline.py``) at K = (K, 4K), the graph
replay against the eager launches in turns, ms per match. ``--root``: the
checkout whose ``roborts_slam_tpu_torch`` runs (a parent tree has no
``step_graph`` argument: its engine runs as it ships, and its figures are
printed under ``"parent"``). One JSON line per measurement; the card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--legs", default="leg1,leg3,leg4,leg3_pipelined")
    ap.add_argument("--scans", type=int, default=120)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--headline", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import inspect
    import os

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from roborts_slam_tpu_torch import SlamEngine, load_config
    from roborts_slam_tpu_torch.bench import parity
    from roborts_slam_tpu_torch.config import SlamConfig
    from roborts_slam_tpu_torch.ops.cuda import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    has_graph = "step_graph" in inspect.signature(SlamEngine.__init__).parameters
    tag = args.tag or ("change" if has_graph else "parent")
    print(json.dumps({"device": smi, "root": str(root), "tag": tag, "torch": torch.__version__}),
          flush=True)
    build.build_all()
    loop = parity.corridor_loop_log()
    willow = parity.leg_inputs("leg1")
    legs = {
        "leg1": (load_config(str(HERE / "configs" / "simulation.yaml"), max_points=1152,
                             world_size=30.0), willow, 30.0, {}, "1"),
        "leg3": (load_config(str(HERE / "configs" / "real_robot.yaml")),
                 dict(laser=loop.laser, ranges=loop.ranges, odom=loop.odom, times=loop.times),
                 None, {}, "2"),
        "leg4": (SlamConfig().replace(max_points=1152),
                 dict(laser=loop.laser, ranges=loop.ranges, odom=loop.odom, times=loop.times),
                 40.0, {}, "1"),
        "leg3_pipelined": (load_config(str(HERE / "configs" / "real_robot.yaml")),
                           dict(laser=loop.laser, ranges=loop.ranges, odom=loop.odom,
                                times=loop.times), None, {"pipelined_fetch": True}, "2"),
        "leg3_async": (load_config(str(HERE / "configs" / "real_robot.yaml")),
                       dict(laser=loop.laser, ranges=loop.ranges, odom=loop.odom,
                            times=loop.times), None, {"synchronous_backend": False}, "1"),
    }

    def engine(name, graph):
        cfg, feed, world, kw, _ = legs[name]
        kw = dict(kw)
        if has_graph:
            kw["step_graph"] = graph
        return SlamEngine(cfg, feed["laser"], world_size=world, **kw)

    def run(name, graph, n, prof=None):
        feed = legs[name][1]
        os.environ["ROBORTS_CORR_KERNEL"] = legs[name][4]
        eng = engine(name, graph)
        summaries, first_at, stamps = [], {}, []
        # how many kept scans the back end has yet to add to its graph when a
        # fused step predicts chains (the asynchronous worker's lag)
        lags, prepare = [], eng._prepare_fused

        def prepare_seen(*a, **kw):
            out = prepare(*a, **kw)
            if out is not None:
                lags.append(len(eng.store) - eng.backend.graph.num_vertices)
            return out
        eng._prepare_fused = prepare_seen
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # a device-wide synchronisation while the asynchronous worker captures
        # a graph would be refused: that engine is joined (finish) first
        sync = eng.synchronous_backend
        for i in range(n):
            if prof is not None and i == n - prof[1]:
                if sync:
                    torch.cuda.synchronize()
                prof[0].__enter__()
                tp = time.perf_counter()
            eng.process(feed["ranges"][i], feed["odom"][i], float(feed["times"][i]))
            summaries.append(None if getattr(eng, "last_summary", None) is None
                             else eng.last_summary.copy())
            stamps.append(time.perf_counter())
            for key in getattr(eng, "_programs", {}):
                first_at.setdefault("_".join(map(str, (key[0], key[2] and key[2][0]))), i)
        if not sync:
            eng.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof[0].__exit__(None, None, None)
            prof.append(time.perf_counter() - tp)
        eng.finish()
        torch.cuda.synchronize()
        eng.first_scan_by_program, eng.stamps, eng.lags = first_at, stamps, lags
        return eng, summaries, wall

    def state_of(eng):
        st, n = eng.state, len(eng.store)
        out = {k: v.detach().cpu().numpy() for k, v in (
            ("pub_hits", st.pub.hits), ("pub_passes", st.pub.passes),
            ("coarse", st.coarse.probs), ("fine", st.fine.probs), ("pose", st.pose))}
        if eng.store._dev_points is not None:
            out["store_points"] = eng.store._dev_points[:n].cpu().numpy()
            out["store_poses"] = eng.store._dev_poses[:n].cpu().numpy()
        out["traj"] = eng.trajectory_array()
        return out

    def equal(a, b):
        if a.keys() != b.keys():
            return False
        return all(x.shape == y.shape and np.array_equal(x, y) for x, y in
                   ((a[k], b[k]) for k in a))

    for name in [x for x in args.legs.split(",") if x]:
        n = min(args.scans, len(legs[name][1]["times"]))
        for r in range(args.runs):
            rec = {"leg": name, "scans": n, "run": r, "tag": tag}
            got = {}
            paths = (True, False) if r % 2 == 0 else (False, True)
            for graph in (paths if has_graph else (False,)):
                eng, summaries, wall = run(name, graph, n)
                key = "graph" if graph else ("eager" if has_graph else "parent")
                d = eng.diag
                got[key] = (summaries, state_of(eng))
                rec[key] = {"ms_per_scan_fed": 1e3 * wall / n, "kept": len(eng.store),
                            "closures": eng.backend.num_loop_closures,
                            "recenters": d.recenters,
                            "step_graph": getattr(d, "step_graph", None),
                            "captures": getattr(d, "captures_by_key", None),
                            "replays": getattr(d, "replays_by_key", None),
                            "eager_steps": getattr(d, "eager_steps", None),
                            "first_scan_by_program": eng.first_scan_by_program,
                            "fused_steps": d.fused_steps,
                            "fused_hits": eng.backend.num_fused_hits,
                            "fused_misses": eng.backend.num_fused_misses,
                            "separate_batches": eng.backend.num_chain_dispatches,
                            "backend_lag_at_fused_steps": (
                                [min(eng.lags), float(np.median(eng.lags)), max(eng.lags)]
                                if eng.lags else None)}
                del eng
                torch.cuda.empty_cache()
            if has_graph:
                (sg, xg), (se, xe) = got["graph"], got["eager"]
                rec["summaries_bit_equal"] = len(sg) == len(se) and all(
                    (a is None and b is None) or (a is not None and b is not None
                                                  and np.array_equal(a, b))
                    for a, b in zip(sg, se))
                rec["state_bit_equal"] = equal(xg, xe)
                first = next((i for i, (a, b) in enumerate(zip(sg, se))
                              if (a is None) != (b is None)
                              or (a is not None and not np.array_equal(a, b))), None)
                rec["first_differing_step"] = first
            print(json.dumps(rec), flush=True)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            for graph in ((True, False) if has_graph else (False,)):
                p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof = [p, args.profile]
                run(name, graph, n, prof=prof)
                # the same scans unprofiled (the profiler slows the host)
                N = args.profile
                stamps = run(name, graph, n)[0].stamps
                plain = stamps[-1] - stamps[-1 - N]
                rows = p.key_averages()
                calls = {k: sum(e.count for e in rows if e.key == k) for k in (
                    "cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                    "cudaMemsetAsync", "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx")}
                kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
                busy_us = sum(e.self_device_time_total for e in kernels)
                print(json.dumps({"leg": name, "tag": tag,
                                  "profile": "graph" if graph else "eager",
                                  "scans": N,
                                  "host_launch_calls_per_scan": {
                                      k: v / N for k, v in calls.items() if v},
                                  "host_launch_calls_per_scan_total": sum(calls.values()) / N,
                                  "device_kernels_per_scan": sum(e.count for e in kernels) / N,
                                  "device_busy_ms_per_scan": busy_us / 1e3 / N,
                                  "profiled_ms_per_scan": prof[2] * 1e3 / N,
                                  "unprofiled_ms_per_scan": plain * 1e3 / N,
                                  "device_idle_share_of_unprofiled_wall":
                                      1 - busy_us / 1e6 / plain}), flush=True)
    if args.headline:
        from roborts_slam_tpu_torch.bench import headline as hl
        from roborts_slam_tpu_torch.bench.timing import k_slope_dynamic
        from roborts_slam_tpu_torch.bench.workload import headline_workload

        os.environ["ROBORTS_CORR_KERNEL"] = "1"
        w = headline_workload(device="cuda")
        ks = (args.headline, 4 * args.headline)
        order = (True, False, False, True) if has_graph else (False,)
        for graph in order:
            f = hl.match_chain(w, graph=graph) if has_graph else hl.match_chain(w)
            sec, detail = k_slope_dynamic(f, k_points=ks, reps=3)
            print(json.dumps({"headline": "graph" if graph else ("eager" if has_graph
                                                                 else "parent"), "tag": tag,
                              "k_points": list(ks), "ms_per_match": sec * 1e3,
                              "t_k": [detail["t_k1"], detail["t_k2"]]}), flush=True)
        if has_graph:
            a = hl.match_chain(w, graph=True)(0, 8)
            b = hl.match_chain(w, graph=False)(0, 8)
            print(json.dumps({"headline_graph_equals_eager": bool(torch.equal(a, b)),
                              "sum": [float(a), float(b)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
