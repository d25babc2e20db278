#!/usr/bin/env python3
"""The pose-graph solve on the card: the graph-replayed solve beside the
eager masked one and the dense one, on synthetic loop graphs; and the loop
closure of legs 3 and 5, a parent tree against this one in turns.

    python3 scripts/torch_spa_on_device.py [--nodes 512,1024] [--tag NAME]
                                           [--root PARENT [--legs leg3,leg5,laps]
                                            [--laps 3.15] [--seed 20]]

Per graph (``parallel.multihost.make_synthetic_loop_graph``, seed 0: an
odometry ring with a quarter as many loop edges, its poses noisy) one JSON
line: the seconds of each solve (host clock to the end of a
``torch.cuda.synchronize``) and of the host's part alone (until the call
returns), LM iterations, CUDA graph captures and replays a solve (the first
solve at a shape captures its program, every later one replays it),
implicit synchronisations inside ``lm_solve`` (``set_sync_debug_mode
("error")`` raises on the first), the graph-replayed solve against the
eager masked one under deterministic sums (bit for bit expected) and in the
default mode (atomic sums), the solve run on a worker thread while this
thread keeps launching and reading (the engine's asynchronous back end),
and the card's name and power limit.

``--root PARENT``: a parent's unpacked tree. The legs (``--legs``: ``leg3``,
chip_smoke's leg 3 through the API, ``configs/real_robot.yaml``, the second
correlation kernel, blocking; ``leg5``, the same log with the back end on
its worker thread and the first kernel, as leg 5 runs it; ``laps``, leg 3
blocking on the same corridor driven ``--laps`` times round, simulated from
``--seed``, where loops close again and again) then run for the parent and
for this tree in turns (parent, change, change, parent), each run in a
process of its own that imports that tree's package, on the corridor-loop
logs simulated once here. One JSON line a run: ms per fed scan (first scan
to ``finish()`` and a synchronise), ``solve_and_correct_s`` (the back end's
host clock over its solves and corrections), ``worker_longest_pass_s`` (the
longest back-end pass, the worker's stall in ``leg5``), the closures and
solves; every solve with its graph's nodes and edges, the stored scans, the
buckets they fall in (JAX's ``64·2^k``) and its seconds; the solves per
bucket and the share of solves that fall in a bucket an earlier solve of
the run had (the ones a program per bucket can serve by replay); and what
``diag`` says of the closure's programs where the tree has them.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def bucket_of(count: int) -> int:
    """JAX's shape bucket: the smallest ``64·2^k`` that holds ``count``."""
    b = 64
    while b < count:
        b *= 2
    return b


def run_leg(tree: str, leg: str, log_path: str, tag: str) -> dict:
    """One run of ``leg`` with the package of ``tree`` (imported by the
    caller) on a saved corridor log."""
    import os

    import numpy as np
    import torch

    from roborts_slam_tpu_torch import SlamEngine, load_config
    from roborts_slam_tpu_torch.backend.processor import Backend
    from roborts_slam_tpu_torch.models.scan import LaserModel

    d = np.load(log_path)
    laser = LaserModel.from_array(d["laser"])
    cfg = load_config(str(Path(tree) / "configs" / "real_robot.yaml"))
    os.environ["ROBORTS_CORR_KERNEL"] = "1" if leg == "leg5" else "2"
    passes, solves = [], []
    orig = SlamEngine._backend_pass

    def timed_pass(self, batch):
        t = time.perf_counter()
        try:
            return orig(self, batch)
        finally:
            passes.append(time.perf_counter() - t)

    solve = Backend._solve_and_correct

    def timed_solve(self):
        nodes, edges, scans = self.graph.num_vertices, len(self.graph.edges), len(self.store)
        t = time.perf_counter()
        try:
            return solve(self)
        finally:
            solves.append({"nodes": nodes, "edges": edges, "scans": scans,
                           "bucket": [bucket_of(nodes), bucket_of(max(edges, 1)),
                                      bucket_of(scans)],
                           "seconds": time.perf_counter() - t})

    SlamEngine._backend_pass = timed_pass
    Backend._solve_and_correct = timed_solve
    eng = SlamEngine(cfg, laser, synchronous_backend=leg != "leg5")
    n = len(d["times"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(n):
        eng.process(d["ranges"][i], d["odom"][i], float(d["times"][i]))
    eng.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    back, diag = eng.backend, eng.diag
    per_bucket: dict = {}
    for rec in solves:
        key = "x".join(str(b) for b in rec["bucket"])
        per_bucket[key] = per_bucket.get(key, 0) + 1
    return {"leg": leg, "tag": tag, "tree": tree, "scans_fed": n, "kept": len(eng.store),
            "ms_per_scan_fed": 1e3 * wall / n, "loop_closures": back.num_loop_closures,
            "spa_solves": back.num_solves, "solve_and_correct_s": back.solve_time_s,
            "worker_longest_pass_s": max(passes, default=0.0), "backend_passes": len(passes),
            "solves": solves, "solves_per_bucket": per_bucket,
            "share_in_a_bucket_seen_before": (len(solves) - len(per_bucket)) / len(solves)
            if solves else None,
            "fused_hits": back.num_fused_hits, "fused_misses": back.num_fused_misses,
            **{k: getattr(diag, k) for k in (
                "closure_path", "rebuild_path", "eager_rebuilds", "solve_lm_iters",
                "solve_cg_steps", "closure_capture_s") if hasattr(diag, k)},
            "programs": {k: v for k, v in getattr(diag, "captures_by_key", {}).items()
                         if k.startswith(("solve_", "rebuild_"))},
            "program_replays": {k: v for k, v in getattr(diag, "replays_by_key", {}).items()
                                if k.startswith(("solve_", "rebuild_"))}}


def legs_in_turns(args, card: str) -> int:
    """The legs of ``--root`` and of this tree in turns, a process a run."""
    import tempfile

    import numpy as np

    from roborts_slam_tpu_torch.bench.parity import LOOP_LAPS, LOOP_SEED, corridor_loop_log

    legs = [x for x in args.legs.split(",") if x]
    with tempfile.TemporaryDirectory() as tmp:
        logs = {}
        for name in sorted({"laps" if leg == "laps" else "leg" for leg in legs}):
            laps, seed = (args.laps, args.seed) if name == "laps" else (LOOP_LAPS, LOOP_SEED)
            t = time.perf_counter()
            loop = corridor_loop_log(laps, seed)
            logs[name] = str(Path(tmp) / f"corridor_{name}.npz")
            np.savez(logs[name], laser=loop.laser.to_array(), ranges=loop.ranges,
                     odom=loop.odom, times=loop.times)
            print(json.dumps({"log": name, "scans": len(loop.times), "laps": laps,
                              "seed": seed, "simulated_s": time.perf_counter() - t}),
                  flush=True)
        trees = {"parent": str(Path(args.root).resolve()), "change": str(HERE)}
        ok = True
        for leg in legs:
            log_path = logs["laps" if leg == "laps" else "leg"]
            for tag in ("parent", "change", "change", "parent"):
                proc = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()), "--leg-run", leg,
                     "--tree", trees[tag], "--log", log_path, "--tag", tag],
                    capture_output=True, text=True, timeout=600)
                lines = proc.stdout.strip().splitlines()
                if proc.returncode != 0 or not lines:
                    ok = False
                    print(json.dumps({"leg": leg, "tag": tag, "device": card,
                                      "error": proc.stderr[-2000:]}), flush=True)
                    continue
                rec = json.loads(lines[-1])
                rec["device"] = card
                print(json.dumps(rec), flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--legs", default="leg3,leg5")
    ap.add_argument("--laps", type=float, default=3.15)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--nodes", default="512,1024")
    ap.add_argument("--tag", default="")
    ap.add_argument("--leg-run", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--log", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree or HERE).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.leg_run:
        print(json.dumps(run_leg(args.tree, args.leg_run, args.log, args.tag)), flush=True)
        return 0
    from roborts_slam_tpu_torch.backend import spa
    from roborts_slam_tpu_torch.parallel.multihost import make_synthetic_loop_graph

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "closure_path": spa.closure_path(dev)
                      if hasattr(spa, "closure_path") else None}), flush=True)
    masked = "replay" in inspect.signature(spa.lm_solve).parameters
    calls = {"capture_begin": 0, "replay": 0}

    def counting(name):
        orig = getattr(torch.cuda.CUDAGraph, name)

        def inner(self, *a, **kw):
            calls[name] += 1
            return orig(self, *a, **kw)
        return inner

    for name in calls:
        setattr(torch.cuda.CUDAGraph, name, counting(name))

    def timed(fn):
        torch.cuda.synchronize()
        before = dict(calls)
        t = time.perf_counter()
        out = fn()
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return out, {"seconds": time.perf_counter() - t, "host_seconds": host,
                     **{k: calls[k] - before[k] for k in calls}}

    @contextlib.contextmanager
    def deterministic():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*deterministic.*")
                yield
        finally:
            torch.use_deterministic_algorithms(False)

    def compared(a, b):
        (pa, ca, ia), (pb, cb, ib) = a, b
        return {"max_pose_diff": float((pa - pb).abs().max()),
                "cost_rel_diff": abs(float(ca) - float(cb)) / max(abs(float(cb)), 1e-30),
                "iters": [int(ia), int(ib)],
                "bit_equal": torch.equal(pa, pb) and torch.equal(ca, cb)}

    ok = True
    for n in (int(v) for v in args.nodes.split(",") if v):
        g = make_synthetic_loop_graph(n, device=dev)
        line = {"tag": args.tag, "device": card, "torch": torch.__version__,
                "cuda": torch.version.cuda, "nodes": n,
                "edges": int(g.edge_ij.shape[0]), "masked": masked}
        spa.solve_pose_graph(g)                      # first use of each op
        spa.solve_pose_graph_dense(g)
        (p, c, it), line["solve"] = timed(lambda: spa.solve_pose_graph(g))
        line["solve"]["iters"], line["solve"]["cost"] = int(it), float(c)
        syncs = spa.host_syncs
        _, line["dense"] = timed(lambda: spa.solve_pose_graph_dense(g))
        line["dense"]["host_syncs"] = spa.host_syncs - syncs
        if masked:
            eager, line["eager_masked"] = timed(lambda: spa.lm_solve(g, replay=False))
            line["default_mode_replayed_vs_eager"] = compared((p, c, it), eager)
            torch.cuda.set_sync_debug_mode("error")
            try:
                spa.lm_solve(g)
                torch.cuda.synchronize()
                line["implicit_syncs_in_lm_solve"] = 0
            except RuntimeError as err:
                line["implicit_syncs_in_lm_solve"] = f"raised: {err}"[:300]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            with deterministic():
                rep, line["deterministic_replayed"] = timed(lambda: spa.solve_pose_graph(g))
                eag = spa.lm_solve(g, replay=False)
                line["deterministic_replayed_vs_eager"] = compared(rep, eag)
                # the same solve on a worker thread while this thread launches,
                # allocates and reads on the card
                box, stop = {}, threading.Event()

                def worker():
                    try:
                        box["out"] = spa.solve_pose_graph(g)
                        torch.cuda.synchronize()
                    except Exception as err:  # noqa: BLE001 — reported below
                        box["error"] = repr(err)[:300]
                    finally:
                        stop.set()

                th = threading.Thread(target=worker)
                reads = 0
                th.start()
                while not stop.is_set():
                    # no random draw: PyTorch refuses one on the card from
                    # another thread while a graph is being captured
                    a = torch.full((256, 256), 1.0 + reads % 7, device=dev)
                    float((a @ a).sum())
                    reads += 1
                th.join(timeout=120)
                line["threaded"] = {"front_reads": reads, **(
                    {"error": box["error"]} if "error" in box
                    else compared(box["out"], rep))}
            good = (line["implicit_syncs_in_lm_solve"] == 0
                    and line["deterministic_replayed_vs_eager"]["bit_equal"]
                    and line["threaded"].get("bit_equal", False))
            line["ok"] = good
            ok = ok and good
        print(json.dumps(line), flush=True)
    if args.root is not None:
        ok = legs_in_turns(args, card) == 0 and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
