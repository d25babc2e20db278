#!/usr/bin/env python3
"""The pose-graph solve on the card: the graph-replayed solve beside the
eager masked one and the dense one, on synthetic loop graphs; and the loop
closure of legs 3 and 5, a parent tree against this one in turns.

    python3 scripts/torch_spa_on_device.py [--nodes 512,1024] [--tag NAME]
                                           [--buckets 512,1024,2048,4096]
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
eager masked one under deterministic sums and in the default mode (atomic
sums; the replayed solve's CG is the kernel, the eager one's the masked
loop: the cost within 1e-4 relative expected, not the bits), the solve run
on a worker thread while this thread keeps launching and reading (the
engine's asynchronous back end; bit for bit the replayed solve), and the
card's name and power limit.

Per node bucket of ``--buckets`` (a loop graph of 3/4 as many nodes, made
from the bucket's seed, padded to the bucket and its edges' bucket) one
JSON line a way of solving: the bucket's ``SolveProgram`` made anew (its CG
the kernel ``spa_pcg``), its first solve (the capture) and then device
milliseconds a solve (CUDA events, median of 3), LM iterations, CG steps,
the cost at the start and at the end (the graph's measurements are exact:
the optimum's cost is float32's noise, 1e-8–1e-7 here), and the kernel
alone at the graph's first LM iteration (``kernel_alone``: held against
the masked ``_pcg`` on the same inputs, ms a launch, µs a CG step, its
bound); then the masked loop launched eagerly (``lm_solve(replay=False)``,
one solve). With ``--root`` the parent's program (whatever its CG) runs
too, each tree in a process of its own, in turns (parent, change, change,
parent).

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
import dataclasses
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
                "closure_path", "solve_lm_iters", "solve_cg_steps", "closure_capture_s")
                if hasattr(diag, k)},
            "programs": {k: v for k, v in getattr(diag, "captures_by_key", {}).items()
                         if k.startswith("solve_")},
            "program_replays": {k: v for k, v in getattr(diag, "replays_by_key", {}).items()
                                if k.startswith("solve_")}}


def padded_loop_graph(spa, bn: int, dev, pe: int | None = None):
    """A loop graph (``make_synthetic_loop_graph``, seed ``bn``) padded as
    ``as_solver_data`` pads one, to ``bn`` nodes and ``pe`` edges (None:
    its edges' bucket): padding nodes masked at zero poses, padding edges
    masked at (0, 0) with identity information. ``3·bn/4`` nodes (at most
    ``3·pe/4``) and half as many loop edges as nodes, fewer where ``pe``
    holds no more."""
    import torch

    from roborts_slam_tpu_torch.parallel.multihost import make_synthetic_loop_graph

    n = 3 * bn // 4 if pe is None else min(3 * bn // 4, 3 * pe // 4)
    frac = 0.5 if pe is None else min(0.5, (pe - n) / n)
    g = make_synthetic_loop_graph(n, loop_frac=frac, seed=bn, device=dev)
    e = g.edge_ij.shape[0]
    pe = bucket_of(e) if pe is None else pe

    def pad(t, rows, fill=0):
        out = torch.full((rows, *t.shape[1:]), fill, dtype=t.dtype, device=dev)
        out[:t.shape[0]] = t
        return out

    info = torch.eye(3, device=dev).repeat(pe, 1, 1)
    info[:e] = g.edge_info
    return spa.PoseGraphData(poses=pad(g.poses, bn), node_mask=pad(g.node_mask, bn),
                             edge_ij=pad(g.edge_ij, pe), edge_rel=pad(g.edge_rel, pe),
                             edge_info=info, edge_mask=pad(g.edge_mask, pe))


def bucket_lines(buckets, tag: str = "", tree: str = ""):
    """The solves of the imported package at each bucket (see the module's
    docstring): one dict a way of solving."""
    import importlib.util
    import statistics

    import torch

    from roborts_slam_tpu_torch.backend import spa

    dev = torch.device("cuda", 0)
    has_kernel = importlib.util.find_spec("roborts_slam_tpu_torch.ops.cuda.spa_pcg") is not None
    for bn in buckets:
        data = padded_loop_graph(spa, bn, dev)
        pn, pe = data.poses.shape[0], data.edge_ij.shape[0]
        start_cost = float(spa.graph_cost(data.poses, data))
        line = {"tag": tag, "tree": tree, "bucket": [pn, pe], "start_cost": start_cost}
        prog = spa.SolveProgram(dev, pn, pe, 50, 100)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prog(data)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        ms, host = [], []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            t = time.perf_counter()
            packed = prog(data)
            host.append(time.perf_counter() - t)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        got = packed.cpu()
        yield {**line, "program": "kernel" if has_kernel else "parent",
               "first_solve_s": first_s, "device_ms_per_solve": statistics.median(ms),
               "device_ms_all": ms, "host_ms_per_solve": 1e3 * statistics.median(host),
               "cost": float(got[-3]), "lm_iters": int(got[-2]), "cg_steps": int(got[-1]),
               **({"kernel": kernel_alone(spa, data)} if has_kernel else {})}
        del prog
        torch.cuda.empty_cache()
        if has_kernel:
            # the masked loop launched eagerly (``lm_solve(replay=False)``),
            # once: the parent's program is the masked loop replayed (--root)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            poses, cost, it = spa.lm_solve(data, replay=False)
            ev[1].record()
            torch.cuda.synchronize()
            yield {**line, "program": "eager_masked", "device_ms_per_solve":
                   ev[0].elapsed_time(ev[1]), "cost": float(cost), "lm_iters": int(it)}


def _masked_residuals(spa, data, lin, b, lam, pinv, iters: int, tol: float):
    """‖r‖ before each step of the masked loop's arithmetic (float32, on
    the card, no stop), and the stop test's threshold."""
    import torch

    def precond(v):
        return torch.einsum("nij,nj->ni", pinv, v) * lin.gauge

    r, z = b, precond(b)
    p, rz = z, torch.sum(b * z)
    thr = float(tol * torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12))
    out = []
    for _ in range(iters + 1):
        out.append(float(torch.sqrt(torch.sum(r * r))))
        hp = spa._hvp(lin, data, p) + lam * (p * lin.gauge)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp(rz, min=1e-20) * p
        rz = rz_new
    return out, thr


EARLY_STEPS = 10      # ``kernel_alone``'s early comparison, before float32's rounding grows


@contextlib.contextmanager
def deterministic_sums():
    """PyTorch's deterministic algorithms inside the block (index_add_ sums
    in a fixed order), their warnings silenced."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def kernel_alone(spa, data) -> dict:
    """The CG kernel at ``data``'s first LM iteration, held against the
    masked ``_pcg`` on the same inputs: the steps of both (the masked loop
    in float32; where they differ, whether the masked loop's ‖r‖ at the
    first step where they part lies within 1e-4 of the stop test's
    threshold, ``near_threshold``); x's largest gap from the masked loop
    run in float64 for as many steps as the kernel took, over ‖x‖
    (``x_gap_rel``), beside the masked loop's own in float32 for as many
    steps, the larger of its atomic and deterministic sums
    (``plain_x_gap_rel``: float32's rounding, which grows over the steps on
    a graph of long chains), and the kernel's after ``EARLY_STEPS`` steps
    (``x_gap_rel_early``, the kernel launched with that budget); its time:
    ms a launch over 20 launches between two events, µs a step, the masked
    ``_pcg``'s ms on the same inputs (``plain_ms``), and its bound: the
    bytes it reads once (four Jacobian entries, the information, the
    endpoints and two incidence entries an edge; b, the gauge, the
    preconditioner block and the list's start a node) and writes once (x)
    over 3.35 TB/s; the operations (an edge's
    two 3×3 products, its information and two transposed products, ≈ 90
    flops a step; a node's preconditioner and updates, ≈ 40) are far below
    the card's peak."""
    import torch

    from roborts_slam_tpu_torch.ops.cuda import spa_pcg

    gauge = spa._gauge_mask(data)
    lin = spa._linearize(data.poses, data, gauge)
    b = -spa._gradient(lin, data.poses, data)
    lam = torch.full((), 1e-4, device=b.device)
    pinv = spa._preconditioner(lin, data, lam).contiguous()
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    ptr, entries = spa_pcg.incidence(data.edge_ij, data.poses.shape[0])
    args = (lin.ja, lin.jb, lin.info, gauge, pinv, b, lam, done, data.edge_ij, ptr, entries,
            100, 1e-6)
    x, steps = spa_pcg.pcg(*args)
    again = spa_pcg.pcg(*args)
    ks = int(steps)
    _, masked_steps = spa._pcg(lin, data, b, lam, 100, 1e-6)
    ms_ = int(masked_steps)
    d64 = data._replace(poses=data.poses.double(), edge_rel=data.edge_rel.double(),
                        edge_info=data.edge_info.double())
    lin64 = spa._Linearization(*(t.double() for t in lin))

    def f64(k):
        return spa._pcg(lin64, d64, b.double(), lam.double(), k, 0.0)[0]

    def gap(got, want):
        return float((got.double() - want).abs().max()) / max(
            float(torch.linalg.vector_norm(want)), 1e-30)

    want = f64(ks)
    scale = float(torch.linalg.vector_norm(want))
    plain = [gap(spa._pcg(lin, data, b, lam, ks, 0.0)[0], want)]
    with deterministic_sums():
        plain.append(gap(spa._pcg(lin, data, b, lam, ks, 0.0)[0], want))
    early = min(EARLY_STEPS, ks)
    x_early, _ = spa_pcg.pcg(*args[:11], early, 0.0)
    near = None
    if ks != ms_:
        norms, thr = _masked_residuals(spa, data, lin, b, lam, pinv, 100, 1e-6)
        near = abs(norms[min(ks, ms_)] - thr) <= 1e-4 * thr
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(20):
        spa_pcg.pcg(*args)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / 20
    ev[0].record()
    for _ in range(3):
        spa._pcg(lin, data, b, lam, 100, 1e-6)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1]) / 3
    n, e = data.poses.shape[0], data.edge_ij.shape[0]
    nbytes = e * (4 * 4 + 9 * 4 + 2 * 8 + 2 * 4) + n * (3 * 4 + 4 + 9 * 4 + 4 + 3 * 4)
    geo = spa_pcg.geometry(n, e)
    return {"ms_per_launch": ms, "steps": ks, "masked_steps": ms_, "near_threshold": near,
            "x_gap_rel": gap(x, want), "plain_x_gap_rel": max(plain),
            "x_gap_rel_early": gap(x_early, f64(early)), "early_steps": early,
            "x_norm": scale, "repeats_its_bits": torch.equal(x, again[0])
            and ks == int(again[1]), "us_per_step": 1e3 * ms / max(ks, 1),
            "plain_ms": plain_ms, "bytes": nbytes,
            "operations": max(ks, 1) * (90 * e + 40 * n),
            "bound_ms": nbytes / 3.35e12 * 1e3,
            "roofline_pct": 100 * nbytes / 3.35e12 * 1e3 / ms,
            "geometry": dataclasses.asdict(geo)}


def buckets_in_turns(args, card: str) -> int:
    """``bucket_lines`` of this tree, and of ``--root`` in turns with it, a
    process a run."""
    trees = [("change", str(HERE))]
    if args.root is not None:
        parent = str(Path(args.root).resolve())
        trees = [("parent", parent), ("change", str(HERE)), ("change", str(HERE)),
                 ("parent", parent)]
    ok = True
    for tag, tree in trees:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--bucket-run",
                               "--tree", tree, "--buckets", args.buckets, "--tag", tag],
                              capture_output=True, text=True, timeout=900)
        for ln in proc.stdout.strip().splitlines():
            rec = json.loads(ln)
            rec["device"] = card
            print(json.dumps(rec), flush=True)
        if proc.returncode != 0:
            ok = False
            print(json.dumps({"buckets": tag, "device": card, "error": proc.stderr[-2000:]}),
                  flush=True)
    return 0 if ok else 1


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
    ap.add_argument("--buckets", default="512,1024,2048,4096")
    ap.add_argument("--bucket-run", action="store_true", help=argparse.SUPPRESS)
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
    buckets = [int(v) for v in args.buckets.split(",") if v]
    if args.bucket_run:
        for line in bucket_lines(buckets, args.tag, args.tree):
            print(json.dumps(line), flush=True)
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
            with deterministic_sums():
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
            # the replayed solve runs the CG kernel where the eager one runs
            # the masked CG: the two agree in cost, not in bits
            same = line["deterministic_replayed_vs_eager"]
            good = (line["implicit_syncs_in_lm_solve"] == 0
                    and (same["bit_equal"] or same["cost_rel_diff"] <= 1e-4)
                    and line["threaded"].get("bit_equal", False))
            line["ok"] = good
            ok = ok and good
        print(json.dumps(line), flush=True)
    if buckets:
        ok = buckets_in_turns(args, card) == 0 and ok
    if args.root is not None and args.legs:
        ok = legs_in_turns(args, card) == 0 and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
