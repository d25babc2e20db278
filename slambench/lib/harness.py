"""One run of one cell: set-up, the measured window of episodes, the check
against the reference, the metrics and the result line.

A cell (``workloads/<name>.json``) names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<mix>.json``);
its metrics are the ``BENCHMARK.json`` entries that apply to it, each read
by ``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric: a new one is a new file.

The traffic is episodes: one replay of the cell's log through a new engine,
built as the command line's ``run`` builds it, each scan fed through
``process(ranges, odom, t)`` and ``finish()`` called at the end of the log;
episodes follow each other until the window ends, and a partly done last
episode counts what it fed. Set-up warms only what outlives an engine: the
kernel libraries, CUDA and the allocator, and the solve programs of the
node buckets the cell's episodes reach (a throwaway engine's
``warm_backend``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "roborts_slam_tpu")


def err(*a):
    print(*a, file=sys.stderr, flush=True)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str):
    """``read(ctx)`` of metric ``name`` (``metrics/<name>.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def p95(values) -> float:
    """The 95th percentile by the nearest rank: the smallest value that at
    least 95 % of the values do not exceed."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(math.ceil(0.95 * len(v)) - 1, 0)])


class Recorder:
    """What the window records beside the program: per call its seconds
    and whether it applied a loop closure, the sampled steps and closures
    for the check, the seconds the copies for the check took (kept out of
    the window and out of every call's time), and in a traced run each
    call's counters for the kernel readers.

    Samples are drawn over the window's time, from the seed: the first
    ``start_steps`` calls of the first episode; for each of ``steps`` times
    drawn over the whole window, the first call at or after it; for each of
    ``chain_steps`` times, the first call from then on that runs a chain
    batch (the state is copied before each call until one does); for each
    of ``closures`` times drawn over the window less ``closure_gap_s``, the
    first loop-closure solve at or after it."""

    def __init__(self, wl: dict, seconds: float, rng):
        s = wl["samples"]
        self.start_steps = s["start_steps"]
        self.step_at = sorted(rng.uniform(0.0, seconds, s["steps"]).tolist())
        self.chain_at = sorted(rng.uniform(0.0, 0.8 * seconds, s.get("chain_steps", 0)).tolist())
        self.closure_at = sorted(rng.uniform(0.0, max(seconds - wl.get("closure_gap_s", 0.0), 0.0),
                                             s["closures"]).tolist())
        self.durations, self.closure_durations = [], []
        self.steps, self.closures = [], []
        self.pause = 0.0
        self.elapsed = None
        self.calls = []          # traced slice: per call what the kernel readers need

    def kind(self, fed: int, t: float):
        """Whether the next call is sampled, and as what: "start", "step",
        "chain" (kept only if it runs a chain batch) or None."""
        if fed < self.start_steps:
            return "start"
        if self.step_at and self.step_at[0] <= t:
            self.step_at.pop(0)
            return "step"
        if self.chain_at and self.chain_at[0] <= t:
            return "chain"
        return None

    def hook(self, eng):
        """Copy the program's state around the sampled pose-graph solves of
        ``eng`` (its state before, the corrected poses and the rebuilt maps
        after)."""
        from lib import check

        orig = eng.backend._solve_and_correct
        rec = self

        def solve_and_correct():
            if not (rec.closure_at and rec.closure_at[0] <= rec.elapsed()):
                return orig()
            rec.closure_at.pop(0)
            t0 = time.perf_counter()
            z = check.program_state(eng)
            t1 = time.perf_counter()
            orig()
            t2 = time.perf_counter()
            obs = check.observe(eng, True, None)
            rec.closures.append({"z": z, "corrected": obs["poses"][:int(eng.backend.graph.num_vertices)],
                                 "maps": obs["maps"], "offsets": obs["offsets"]})
            rec.pause += (t1 - t0) + (time.perf_counter() - t2)

        eng.backend._solve_and_correct = solve_and_correct


def engine_totals(eng) -> dict:
    """The counters and host clocks of one engine that the metrics read."""
    d, b, st = eng.diag, eng.backend, eng.timers.as_dict()
    return {"frontend_step_s": st.get("frontend_step", {}).get("total_s", 0.0),
            "frontend_fetch_s": st.get("frontend_fetch", {}).get("total_s", 0.0),
            "graph_replays": d.graph_replays, "eager_steps": d.eager_steps,
            "graph_captures": d.graph_captures,
            "dedistort_s": d.dedistort_time_s, "scans_dedistorted": d.scans_dedistorted,
            "closure_capture_s": d.closure_capture_s, "loop_closures": d.loop_closures,
            "solve_time_s": b.solve_time_s, "num_solves": b.num_solves,
            "scans_in": d.scans_in, "scans_processed": d.scans_processed,
            "recenters": d.recenters, "fused_steps": d.fused_steps}


def add_totals(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + v for k, v in b.items()}


def _call_counters(eng) -> dict:
    d = eng.diag
    return {"eager": d.eager_steps, "captures": d.graph_captures,
            "keys": dict(d.replays_by_key), "solves": eng.backend.num_solves,
            "dispatches": eng.backend.num_chain_dispatches,
            "front": d.scans_in - d.scans_dropped_move, "kept": d.scans_processed}


def _call_record(eng, before: dict, i: int) -> dict:
    """What the kernel readers need of one call of the traced slice: the
    log's scan index, whether the call ran only replayed programs (no
    eager step, no capture, no solve, no eager chain batch), the chain
    batches it replayed by size, whether it ran a front-end step and kept
    the scan, its pose and the maps' corner and shapes."""
    after = _call_counters(eng)
    keys = {k: after["keys"].get(k, 0) - before["keys"].get(k, 0) for k in after["keys"]}
    chains = {}
    for k, n in keys.items():
        if n and ("_b" in k):
            chains[int(k.rsplit("_b", 1)[1])] = chains.get(int(k.rsplit("_b", 1)[1]), 0) + n
    batch_replays = sum(n for k, n in keys.items() if k.startswith("batch_b"))
    replayed_only = (after["eager"] == before["eager"] and after["captures"] == before["captures"]
                     and after["solves"] == before["solves"]
                     and after["dispatches"] - before["dispatches"] == batch_replays)
    s = eng.last_summary
    return {"i": i, "replayed_only": replayed_only, "chains": chains,
            "front": after["front"] > before["front"], "kept": after["kept"] > before["kept"],
            "pose": None if s is None else np.asarray(s[:3], np.float64),
            "fine_offset": np.array(eng._host_fine_off, np.float64),
            "pub_hw": tuple(eng.state.pub.hits.shape)}


def run(argv=None, t_start=None, _test=None, _control=None) -> int:
    """The run the command line asks for. ``_test`` (tests only): a dict
    that skips the look for a card and runs on ``device`` with ``config``,
    ``mix`` and ``workload`` entries laid over the files' (a small size).
    ``_control`` (``control.py`` only): a list; the check's control is run
    too, on the same sampled steps and closures, judged as the program is,
    and the two verdicts appended to it."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="slambench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = by_name(bench["workloads"], args.workload, "workload")
    conf = by_name(bench["configs"], cell["config"], "configuration")
    wl = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    conf_file = json.loads((ROOT / conf["file"]).read_text())
    metrics = [m for m in bench["per_layer" if args.trace else "end_to_end"]
               if applies(m, cell["name"])]
    test = _test or {}
    conf_file["params"].update(test.get("config", {}))
    wl.update(test.get("workload", {}))

    import torch

    torch.set_num_threads(1)
    if _test is None and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell["chips"]):
        err(f"slambench: {cell['chips']} CUDA card(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found; "
            "the benchmark runs on the card only")
        return 3
    cache = ROOT / ".slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT), str(BENCH / "reference")]
    if _test is None:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        kind = torch.cuda.get_device_name(0)
        err(f"slambench: {kind}, {cell['chips']} card(s) used of {torch.cuda.device_count()}, "
            f"power: {power_limit()}")
    else:
        dev, kind = torch.device(test["device"]), test["device"]

    from roborts_slam_tpu_torch.config import SlamConfig
    from roborts_slam_tpu_torch.engine import SlamEngine
    from roborts_slam_tpu_torch.models.scan import LaserModel
    from roborts_slam_tpu_torch.ops.cuda import build

    from lib import check
    from traffic import corridor

    # ---- set-up ----
    if dev.type == "cuda":
        build.build_all()
    mix = {**corridor.load_mix(cell["traffic"]), **test.get("mix", {})}
    log = corridor.make_log(mix, args.seed, dev)
    cfg = SlamConfig(**conf_file["params"])
    laser = LaserModel.from_array(log.laser.to_array())
    world = conf_file.get("world_size")
    n_log = len(log.times)
    scans = [(log.ranges[i], log.odom[i], float(log.times[i])) for i in range(n_log)]

    def new_engine():
        return SlamEngine(cfg, laser, world_size=world, synchronous_backend=True, device=dev)

    warm = new_engine()
    for s in scans[:wl["warm_scans"]]:
        warm.process(*s)
    warm.warm_backend(solver_buckets=tuple(wl["solver_buckets"]), match_buckets=(),
                      rebuild_buckets=(), calibrate=False)
    del warm
    gc.collect()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    rec = Recorder(wl, args.seconds, np.random.default_rng([args.seed % (2 ** 63), 15]))
    setup_s = time.perf_counter() - t_start
    err(f"slambench: set-up {setup_s:.3f} s, log {n_log} scans")

    # ---- the window ----
    tr = wl["trace"]
    prof = None
    span = (torch.profiler.record_function if args.trace
            else (lambda name: _Null()))
    totals: dict = {}
    episodes, failed, fed = [], 0, 0
    slice_info = {}
    w0 = time.perf_counter()
    elapsed = rec.elapsed = lambda: time.perf_counter() - w0 - rec.pause
    done = False
    while not done:
        ep = {"scans": 0, "kept": 0, "closures": 0}
        t_ep = time.perf_counter()
        p_ep = rec.pause
        with span("slambench.engine_init"):
            eng = new_engine()
        rec.hook(eng)
        try:
            for i, scan in enumerate(scans):
                if elapsed() >= args.seconds:
                    done = True
                    break
                if args.trace and fed == tr["start"] and prof is None:
                    tp = time.perf_counter()
                    # the host's activity too: the harness's spans name the idle gaps
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
                    slice_span = torch.profiler.record_function("slambench.slice")
                    slice_span.__enter__()
                    rec.pause += time.perf_counter() - tp
                    slice_info = {"t0": elapsed(), "fed0": fed}
                sample = rec.kind(fed, elapsed())
                if sample:
                    tp = time.perf_counter()
                    with span("slambench.sample"):
                        z = check.program_state(eng)
                        before = check.counts(eng)
                        eng.last_summary = None
                    rec.pause += time.perf_counter() - tp
                counters = _call_counters(eng) if prof is not None else None
                closures0, pause0 = eng.diag.loop_closures, rec.pause
                t0 = time.perf_counter()
                with span("slambench.process"):
                    kept = eng.process(*scan)
                dt = time.perf_counter() - t0 - (rec.pause - pause0)
                rec.durations.append(dt)
                if eng.diag.loop_closures > closures0:
                    rec.closure_durations.append(dt)
                    ep["closures"] += eng.diag.loop_closures - closures0
                if counters is not None:
                    rec.calls.append(_call_record(eng, counters, i))
                if sample == "chain" and check.counts(eng)["chains"] == before["chains"]:
                    sample = None              # no chain batch: try the next call
                    del z
                elif sample:
                    tp = time.perf_counter()
                    if sample == "chain":
                        rec.chain_at.pop(0)
                    with span("slambench.sample"):
                        rec.steps.append({"z": z, "scan": scan, "before": before,
                                          "got": check.observe(eng, kept, eng.last_summary)})
                    rec.pause += time.perf_counter() - tp
                if i == 0:
                    ep["first_scan_s"] = time.perf_counter() - t_ep - (rec.pause - p_ep)
                ep["scans"] += 1
                ep["kept"] += bool(kept)
                fed += 1
                if prof is not None and fed == tr["start"] + tr["scans"]:
                    slice_span.__exit__(None, None, None)
                    sync()
                    slice_info.update(t1=elapsed(), fed1=fed)
                    tp = time.perf_counter()
                    prof.__exit__(None, None, None)
                    prof_done, prof = prof, None
                    rec.pause += time.perf_counter() - tp
            else:
                with span("slambench.finish"):
                    eng.finish()
        except Exception as e:          # a program fault: counted, and the run is not correct
            failed += 1
            err(f"slambench: episode {len(episodes)} failed: {type(e).__name__}: {e}")
            done = elapsed() >= args.seconds
        ep["seconds"] = time.perf_counter() - t_ep - (rec.pause - p_ep)
        ep["complete"] = ep["scans"] == n_log
        totals = add_totals(totals, engine_totals(eng))
        episodes.append(ep)
        print(json.dumps({"episode": len(episodes) - 1, **ep}), flush=True)
        del eng
    window_s = elapsed()
    if prof is not None:                # the window ended inside the slice
        slice_span.__exit__(None, None, None)
        sync()
        slice_info.update(t1=elapsed(), fed1=fed)
        prof.__exit__(None, None, None)
        prof_done = prof
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the trace ----
    trace_read = None
    if args.trace and slice_info:
        from lib import trace as tracemod

        path = Path(os.environ.get("TMPDIR", str(cache))) / f"slambench_trace_{args.seed}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof_done.export_chrome_trace(str(path))
        trace_read = tracemod.read(tracemod.load(path))
        path.unlink()
        del prof_done
        n_in = slice_info["fed1"] - slice_info["fed0"]
        s_in = slice_info["t1"] - slice_info["t0"]
        rate_in = n_in / s_in if s_in > 0 else float("nan")
        rate_out = ((fed - n_in) / (window_s - s_in)) if window_s > s_in else float("nan")
        print(json.dumps({"traced_slice": {"scans": n_in, "seconds": s_in,
                                           "scans_per_s": rate_in,
                                           "untraced_scans_per_s": rate_out,
                                           "overhead": 1 - rate_in / rate_out}}), flush=True)

    ctx = {"window_s": window_s, "fed": fed, "durations": rec.durations,
           "closure_durations": rec.closure_durations, "setup_s": setup_s,
           "totals": totals, "trace": trace_read, "calls": rec.calls, "config": cfg,
           "laser": laser, "world_size": world, "scans": scans, "device_kind": kind,
           "device": dev}

    # ---- the check ----
    t_check = time.perf_counter()
    rows, ctrl = [], []
    for smp in rec.steps:
        obs, ref_before, seen, margins = check.ref_step(smp["z"], smp["scan"], dev)
        rows.append(check.compare_step(smp["z"], smp["got"], smp["before"], obs, ref_before,
                                       seen, margins))
        if _control is not None:   # the reference in the lower precision, in the program's place
            low, low_before, _, _ = check.ref_step(smp["z"], smp["scan"], dev, lower=True)
            ctrl.append(check.compare_step(smp["z"], {**low, "chains": smp["got"]["chains"]},
                                           {**low_before, "chains": smp["before"]["chains"]},
                                           obs, ref_before, seen, margins))
    cl_rows = [check.check_closure(c, dev) for c in rec.closures]
    numbers = check.summarize(rows, cl_rows)
    correct, judged = check.verdict(numbers, failed, wl)
    if _control is not None:
        c_numbers = check.summarize(
            ctrl, [check.check_closure(c, dev, lower=True) for c in rec.closures])
        c_correct, c_judged = check.verdict(c_numbers, 0, wl)
        print(json.dumps({"control": {**c_numbers, "correct": c_correct, "check": c_judged}}),
              flush=True)
        _control.append({"seed": args.seed, "correct": correct, "control_correct": c_correct})
    check_s = time.perf_counter() - t_check
    keep = ("chain", "decisions", "pose_gap_m", "edge_gap_m", "score_gap", "cov_rel_gap",
            "map_cells", "flip", "cov_flip", "margins", "what")
    print(json.dumps({"check": {**numbers, "seconds": check_s,
                                "steps": [{k: r[k] for k in keep} for r in rows],
                                "closures": cl_rows}}), flush=True)

    # ---- metrics and the result ----
    out = {}
    for m in metrics:
        v = load_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        err(f"slambench: the run loaded {found}: no result")
        return 4
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": fed, "failed": failed,
              "metrics": out, "device": device}
    if args.trace and trace_read:
        device.update(busy_s=trace_read["busy_s"], window_s=trace_read["window_s"])
        result["breakdown"] = {"device_ops": trace_read["device_ops"],
                               "idle_gaps": trace_read["idle_gaps"]}
    result["check"] = judged
    for k, v in judged.items():
        bound = f"limit {v['limit']!r}" if "limit" in v else f"at least {v['at_least']!r}"
        err(f"check {k} {v['value']!r} {bound}")
    print(json.dumps(result), flush=True)
    return 0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
