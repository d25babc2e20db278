#!/usr/bin/env python3
"""One cell of the benchmark (``slambench/``) run with the engine's spans
read: the stages that tile ``process()``, the device times of the replayed
programs, the counters of wasted chain rows and CG steps, and the
optimize matcher's (Gauss-Newton) matches, passes and fallbacks.

    python3 scripts/torch_stage_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 scripts/torch_stage_spans.py --span-cost [--root DIR]

The run is ``slambench/run.py``'s, with what the benchmark would need to
read the spans laid on in this process: with ``--trace 1`` every engine's
``timers.device_timing`` set; each window engine's stages (count and host
seconds) and the ten counters added to the harness's totals (the six
Gauss-Newton ones read as 0 from a tree without them); the seconds
of the check's copies made inside ``process()`` calls (the closure hook's)
kept; the traced slice's idle gaps named by the innermost ``slam.`` span
that holds their middle (its ``/<id>`` cut off), the harness's span where
none does. After the harness's own lines it prints, traced, ``{"stages":
{name: {"count", "total_s", "ms_per_scan"}}}`` over the window's engines,
``{"spans": {metric: value}}`` (the per-layer numbers below) and
``{"idle_gaps_named": [[name, seconds], ...]}``; traced or not,
``{"closures": ...}``, the window's closure calls split by whether they
captured a solve program (``closure_split``), and
``{"engines": ...}``, at each new engine the engines still alive, the
card's allocated bytes and the peak so far.

``--span-cost``: the host cost of one stage span with no profiler
recording, beside a ``contextlib`` generator span and ``record_function``
(the tree at ``--root``, default this one), and whether the profiler's
all-threads option exists.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TOP = ("ingest", "frontend_prepare", "frontend_step", "frontend_commit",
       "backend_update", "backend_loop_closure")
# every stage a blocking engine times: the harness sums an engine's totals
# over the keys of the latest engine's, so each engine gives every one
STAGES = TOP + ("dispatch_stage", "dispatch_lookup", "dispatch_replay", "frontend_fetch",
                "recenter", "closure_solve", "closure_correct", "device.step",
                "device.chain_batch", "device.solve", "device.rebuild")


def stage_totals(totals: dict) -> dict:
    """{stage: {"count", "total_s"}} from the flattened totals."""
    out: dict = {}
    for k, v in totals.items():
        if k.startswith("stage."):
            name, what = k[6:].rsplit(".", 1)
            out.setdefault(name, {"count": 0, "total_s": 0.0})[
                "count" if what == "n" else "total_s"] = v
    return out


def span_metrics(ctx: dict, copies_s: float) -> dict:
    """The per-layer numbers the spans give, from one run's context: host
    ms per fed scan of ``ingest``, ``frontend_prepare``, ``frontend_commit``,
    of what no top-level stage holds (the calls' time less the six stages'),
    and of the back-end pass less the solve; the fused rows and CG steps
    used of those run; the device ms of a replayed step and of a solve; the
    share of steps replayed; the Gauss-Newton passes a match and the share
    of matches that fell back to the coarse tier's pose (front end and
    chains together)."""
    t, fed = ctx["totals"], ctx["fed"]
    st = stage_totals(t)

    def s(name):
        return st.get(name, {}).get("total_s", 0.0)

    def per(name):
        return st[name]["total_s"] / st[name]["count"] * 1e3 if st.get(name, {}).get("count") \
            else None

    out = {}
    if fed and st:
        out["ingest.ms_per_scan"] = 1e3 * s("ingest") / fed
        out["engine.prepare_ms_per_scan"] = 1e3 * s("frontend_prepare") / fed
        out["engine.commit_ms_per_scan"] = 1e3 * s("frontend_commit") / fed
        calls = sum(ctx["durations"])
        out["engine.unspanned_ms_per_scan"] = \
            1e3 * (calls - (sum(s(n) for n in TOP) - copies_s)) / fed
        out["engine.process_ms_per_scan"] = 1e3 * calls / fed
        out["backend.pass_ms_per_scan"] = 1e3 * (
            s("backend_update") + s("backend_loop_closure") - t["solve_time_s"]
            - copies_s) / fed
    if t.get("fused_rows_run"):
        out["backend.fused_useful_frac"] = t["fused_rows_used"] / t["fused_rows_run"]
    if per("device.step") is not None:
        out["step_graph.device_ms_per_step"] = per("device.step")
    if per("device.solve") is not None:
        out["closure.solve_device_ms"] = per("device.solve")
    if t.get("cg_steps_run"):
        out["closure.cg_useful_frac"] = t["cg_steps_needed"] / t["cg_steps_run"]
    if t.get("graph_replays", 0) + t.get("eager_steps", 0):
        out["step_graph.replay_frac"] = t["graph_replays"] / (t["graph_replays"]
                                                              + t["eager_steps"])
    matches = t.get("gn_matches", 0) + t.get("chain_gn_matches", 0)
    if matches:
        out["matcher.gn_passes_per_match"] = \
            (t["gn_passes"] + t["chain_gn_passes"]) / matches
        out["matcher.gn_fallback_frac"] = (t["gn_fallbacks"] + t["chain_gn_fallbacks"]) / matches
        out["matcher.gn_matches"] = {"front": t["gn_matches"], "chain": t["chain_gn_matches"]}
        out["matcher.gn_fallbacks"] = {"front": t["gn_fallbacks"],
                                       "chain": t["chain_gn_fallbacks"]}
    return out


def closure_split(records: list) -> dict:
    """The closure calls (``{"ms", "captured", "capture_ms"}`` each: the
    call's host ms less the check's pauses, the solve programs it captured,
    the ms its captures took) split into those that captured a solve
    program and those that did not: count, mean and median ms, and the
    mean of the captures' ms; and the mean and median over all of them."""
    import statistics

    out = {}
    for kind, rows in (("capture", [r for r in records if r["captured"]]),
                       ("no_capture", [r for r in records if not r["captured"]])):
        ms = [r["ms"] for r in rows]
        out[kind] = {"n": len(rows), "mean_ms": statistics.fmean(ms) if ms else None,
                     "median_ms": statistics.median(ms) if ms else None,
                     "capture_ms_mean": statistics.fmean(r["capture_ms"] for r in rows)
                     if rows else None}
    ms = [r["ms"] for r in records]
    out["all_mean_ms"] = statistics.fmean(ms) if ms else None
    out["all_median_ms"] = statistics.median(ms) if ms else None
    out["capture_share"] = out["capture"]["n"] / len(records) if records else None
    return out


def name_gaps(trace: dict, top: int = 10) -> list:
    """The slice's longest idle gaps on the device, as ``lib.trace.read``
    finds them, each named by the innermost ``slam.`` span (its id cut off)
    that holds its middle, else by the harness's span."""
    from lib import trace as tr

    dev, harness_spans = tr.events(trace)
    prog = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][5:].split("/")[0])
                  for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e and e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("slam."))
    sl = [s for s in harness_spans if s[2] == "slice"]
    if not sl or not dev:
        return []
    lo, hi = sl[0][0], sl[0][1]
    held = tr.union([s for s in harness_spans if s[2] == "sample"], lo, hi)
    busy = tr.cut(tr.union(dev, lo, hi), held)
    idle = sorted(tr.cut(tr.gaps(busy, lo, hi), held), key=lambda g: -(g[1] - g[0]))[:top]
    out = []
    for a, b in idle:
        mid = (a + b) / 2
        inner = [(s0, name) for s0, s1, name in prog if s0 <= mid <= s1]
        name = max(inner)[1] if inner else tr.span_at(harness_spans, mid)
        out.append([name, (b - a) * 1e-6])
    return out


def run_cell(argv, _test=None) -> int:
    """``harness.run(argv)`` with the spans read (``_test``: the harness's
    small CPU run, for a rehearsal)."""
    sys.path[:0] = [str(HERE / "slambench"), str(HERE)]
    from lib import harness
    from lib import trace as tr

    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", type=int, default=0)
    traced = bool(ap.parse_known_args(argv)[0].trace)

    import weakref

    import torch

    import roborts_slam_tpu_torch.engine as tengine

    alive: weakref.WeakSet = weakref.WeakSet()
    engines, closures = [], []
    card = torch.cuda.is_available()

    def captured(d):
        return {k: v for k, v in d.captures_by_key.items() if k.startswith("solve_")}

    class Engine(tengine.SlamEngine):
        def __init__(self, *a, **k):
            engines.append({"alive": len(alive),
                            "allocated_gb": torch.cuda.memory_allocated() / 1e9 if card else 0.0,
                            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if card else 0.0})
            super().__init__(*a, **k)
            self.timers.device_timing = traced
            self.rec = None
            alive.add(self)

        def process(self, *a, **k):
            d, rec = self.diag, self.rec
            c0, k0, s0 = d.loop_closures, captured(d), d.closure_capture_s
            p0, t0 = (rec.pause if rec is not None else 0.0), time.perf_counter()
            out = super().process(*a, **k)
            if d.loop_closures > c0:
                dt = time.perf_counter() - t0 - ((rec.pause if rec is not None else 0.0) - p0)
                closures.append({"ms": 1e3 * dt,
                                 "captured": sorted(set(captured(d).items()) - set(k0.items())),
                                 "capture_ms": 1e3 * (d.closure_capture_s - s0)})
            return out

    tengine.SlamEngine = Engine

    totals_of = harness.engine_totals

    def engine_totals(eng):
        out = totals_of(eng)
        st = eng.timers.as_dict()
        for name in STAGES:
            out[f"stage.{name}.n"] = st.get(name, {}).get("count", 0)
            out[f"stage.{name}.s"] = st.get(name, {}).get("total_s", 0.0)
        b = eng.backend
        out.update(fused_rows_run=b.fused_rows_run, fused_rows_used=b.fused_rows_used,
                   cg_steps_needed=b.cg_steps_needed, cg_steps_run=b.cg_steps_run)
        for k in ("gn_matches", "gn_passes", "gn_fallbacks"):
            out[k] = getattr(eng.diag, k, 0)
            out[f"chain_{k}"] = getattr(b, k, 0)
        return out

    harness.engine_totals = engine_totals

    copies = {"s": 0.0}
    hook_of = harness.Recorder.hook

    def hook(rec, eng):
        eng.rec = rec
        solve = eng.backend._solve_and_correct
        inner = {"s": 0.0}

        def timed_solve():
            t0 = time.perf_counter()
            try:
                return solve()
            finally:
                inner["s"] += time.perf_counter() - t0

        eng.backend._solve_and_correct = timed_solve
        hook_of(rec, eng)
        sampled = eng.backend._solve_and_correct

        def outer():
            t0, i0 = time.perf_counter(), inner["s"]
            try:
                return sampled()
            finally:
                copies["s"] += (time.perf_counter() - t0) - (inner["s"] - i0)

        eng.backend._solve_and_correct = outer

    harness.Recorder.hook = hook

    seen: dict = {}
    read_of = tr.read

    def read(trace):
        seen["gaps"] = name_gaps(trace)
        return read_of(trace)

    tr.read = read

    reader_of = harness.load_reader

    def load_reader(name):
        fn = reader_of(name)

        def read_ctx(ctx):
            seen["ctx"] = ctx
            return fn(ctx)
        return read_ctx

    harness.load_reader = load_reader

    rc = harness.run(argv, T_START, _test)
    if rc == 0 and traced and "ctx" in seen:
        ctx = seen["ctx"]
        st = stage_totals(ctx["totals"])
        print(json.dumps({"stages": {k: {**v, "ms_per_scan": 1e3 * v["total_s"] / ctx["fed"]}
                                     for k, v in sorted(st.items())}}), flush=True)
        print(json.dumps({"spans": span_metrics(ctx, copies["s"]),
                          "in_call_copies_s": copies["s"]}), flush=True)
        print(json.dumps({"idle_gaps_named": seen.get("gaps", [])}), flush=True)
    if rc == 0:
        print(json.dumps({"closures": closure_split(closures)}), flush=True)
        print(json.dumps({"engines": engines}), flush=True)
    return rc


def span_cost(root: Path, n: int = 200_000) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from roborts_slam_tpu_torch.utils import profiling

    timers = profiling.StageTimers()
    lock = threading.Lock()
    stats: dict = {}

    @contextlib.contextmanager
    def generator_span(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with lock:
                stats[name] = stats.get(name, 0.0) + dt

    def per_span(make, reps=n):
        t0 = time.perf_counter()
        for _ in range(reps):
            with make("x"):
                pass
        return (time.perf_counter() - t0) / reps * 1e6

    out = {"root": str(root), "torch": torch.__version__}
    for _ in range(2):                       # the second round is the one kept
        out["stage_us"] = per_span(timers.stage)
        out["generator_us"] = per_span(generator_span)
        out["record_function_us"] = per_span(torch.profiler.record_function, n // 10)
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        out["profile_all_threads"] = True
    except TypeError:
        out["profile_all_threads"] = False
    return out


T_START = time.perf_counter()

if __name__ == "__main__":
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if "--span-cost" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--span-cost", action="store_true")
        ap.add_argument("--root", default=str(HERE))
        a = ap.parse_args()
        print(json.dumps({"span_cost": span_cost(Path(a.root).resolve())}), flush=True)
        sys.exit(0)
    sys.exit(run_cell(sys.argv[1:]))
