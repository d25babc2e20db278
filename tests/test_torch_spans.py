"""The port's spans (``utils/profiling.StageTimers``): the stages that tile
``process()``, their spans in a ``torch.profiler`` trace, the per-scan and
per-pass root spans, the device timing's no-op off the card, and the
counters of wasted chain rows and CG steps.

The engine is built as the benchmark builds it (``slambench/``: the
real-robot profile, the corridor-loop log driven 1.15 laps from a seed, a
blocking back end), cut to a small size on the CPU: 181 beams, 256 points,
a 0.05 m fine map and an 8 m match window. The replay keeps ~520 of 762
scans, runs ~160 fused steps, recenters and closes one loop."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from roborts_slam_tpu_torch.config import SlamConfig
from roborts_slam_tpu_torch.engine import SlamEngine
from roborts_slam_tpu_torch.models.scan import LaserModel
from roborts_slam_tpu_torch.utils.profiling import StageTimers, trace

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "slambench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
from traffic import corridor  # noqa: E402  (the benchmark's generator)

_spec = importlib.util.spec_from_file_location(
    "torch_stage_spans", ROOT / "scripts" / "torch_stage_spans.py")
stage_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stage_spans)

TOP = ("ingest", "frontend_prepare", "frontend_step", "frontend_commit",
       "backend_update", "backend_loop_closure")
DISPATCH = ("dispatch_stage", "dispatch_lookup", "dispatch_replay", "frontend_fetch")
SMALL = {"fine_map_resolution": 0.05, "match_map_window": 8.0, "max_points": 256,
         "coarse_search_angle_offset": 0.349}
LASER = {"angle_min": -2.356194490192345, "angle_max": 2.356194490192345,
         "range_min": 0.05, "range_max": 10.0, "num_beams": 181,
         "range_threshold_scale": 0.95, "scan_time": 0.025}
SEED = 3_000_000_019          # past 32 signed bits, as the benchmark's seeds


@pytest.fixture(scope="module")
def corridor_log():
    params = json.loads((BENCH / "configs" / "real_robot.json").read_text())["params"]
    cfg = SlamConfig(**{**params, **SMALL})
    mix = {**corridor.load_mix("corridor_lap"), "laser": LASER}
    log = corridor.make_log(mix, SEED, torch.device("cpu"))
    return cfg, LaserModel.from_array(log.laser.to_array()), log


def _engine(corridor_log, sync=True) -> SlamEngine:
    cfg, laser, _ = corridor_log
    return SlamEngine(cfg, laser, synchronous_backend=sync, device="cpu")


def _feed(eng, log, n):
    for i in range(n):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))


@pytest.fixture(scope="module")
def replay(corridor_log):
    """The whole log through one engine with ``device_timing`` set, and per
    call what its counters moved by."""
    log = corridor_log[2]
    eng = _engine(corridor_log)
    eng.timers.device_timing = True
    b, d = eng.backend, eng.diag
    calls = []
    for i in range(len(log.times)):
        before = (d.fused_steps, d.scans_dropped_gate, b.fused_rows_run, b.fused_rows_used)
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        after = (d.fused_steps, d.scans_dropped_gate, b.fused_rows_run, b.fused_rows_used)
        calls.append([a - z for a, z in zip(after, before)])
    eng.finish()
    return eng, np.array(calls)


def _spans(path) -> list:
    """The ``slam.`` spans of a Chrome trace: (name, start, end, thread)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("name", "").startswith("slam.")]


def _inside(span, outer) -> bool:
    return outer[3] == span[3] and outer[1] <= span[1] and span[2] <= outer[2]


def test_top_level_stages_are_counted_as_often_as_they_run(replay):
    eng, _ = replay
    st, d = eng.timers.stages, eng.diag
    past_gate = d.scans_in - d.scans_dropped_move
    assert st["ingest"].count == d.scans_in == 762
    for name in ("frontend_prepare", "frontend_step", "frontend_commit"):
        assert st[name].count == past_gate, name
    assert st["backend_update"].count == st["backend_loop_closure"].count \
        == d.backend_batches == d.scans_processed
    assert d.loop_closures >= 1 and d.recenters >= 1
    assert st["recenter"].count == d.recenters
    assert st["closure_solve"].count == st["closure_correct"].count == eng.backend.num_solves


def test_dispatch_parts_lie_inside_the_step(replay):
    eng, _ = replay
    st = eng.timers.stages
    step = st["frontend_step"]
    for name in DISPATCH:
        assert st[name].count == step.count, name
        assert st[name].total_s <= step.total_s, name
    assert sum(st[n].total_s for n in DISPATCH) <= step.total_s
    # the closure's parts lie inside the solve's clock and the pass's stage
    parts = st["closure_solve"].total_s + st["closure_correct"].total_s
    assert parts <= eng.backend.solve_time_s <= st["backend_loop_closure"].total_s


def test_device_timing_on_cpu_tensors_records_nothing(replay):
    eng, _ = replay
    assert eng.timers.device_timing
    assert not [k for k in eng.timers.stages if k.startswith("device.")]
    assert eng.timers._pending == [] and eng.timers._events == []


def test_fused_rows_run_and_used(replay):
    eng, calls = replay
    b = eng.backend
    assert 0 < b.fused_rows_used <= b.fused_rows_run
    assert b.num_fused_hits >= 1
    # a fused step's rows count as run at the step, whether or not its scan
    # is kept: one whose scan the gate rejects adds to run only
    fused = calls[:, 0] > 0
    assert (calls[fused, 2] >= 1).all() and (calls[~fused, 2] == 0).all()
    rejected = fused & (calls[:, 1] > 0)
    assert rejected.any()
    assert (calls[rejected, 3] == 0).all()
    assert calls[:, 2].sum() == b.fused_rows_run
    assert calls[:, 3].sum() == b.fused_rows_used


def test_cg_steps_needed_and_run(replay):
    eng, _ = replay
    b = eng.backend
    assert b.num_solves >= 1
    assert b.cg_steps_run == b.num_solves * 50 * 100
    assert 0 < b.cg_steps_needed <= b.cg_steps_run
    assert b.last_solve["cg_steps"] <= b.cg_steps_needed


def test_no_profiler_enters_no_record_function(corridor_log, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(autograd_profiler, "record_function", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    eng = _engine(corridor_log)
    _feed(eng, corridor_log[2], 8)
    eng.finish()
    assert eng.timers.stages["ingest"].count == 8
    assert eng.timers.stages["backend_update"].count >= 1


def test_trace_holds_a_scan_span_per_fed_scan(corridor_log, tmp_path):
    eng = _engine(corridor_log)
    n = 10
    with trace(str(tmp_path)):
        _feed(eng, corridor_log[2], n)
    spans = _spans(tmp_path / "trace.json")
    scans = [s for s in spans if s[0].startswith("slam.scan/")]
    assert sorted(int(s[0].split("/")[1]) for s in scans) == list(range(n))
    d = eng.diag
    counts = {"slam.ingest": n, "slam.frontend_prepare": n - d.scans_dropped_move,
              "slam.frontend_step": n - d.scans_dropped_move,
              "slam.frontend_commit": n - d.scans_dropped_move,
              "slam.backend_update": d.backend_batches,
              "slam.backend_loop_closure": d.backend_batches}
    for name, count in counts.items():
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == count >= 1, name
        assert all(any(_inside(s, o) for o in scans) for s in inner), name
    # blocking: each back-end pass nests in the scan it belongs to
    passes = [s for s in spans if s[0].startswith("slam.backend_pass/")]
    assert len(passes) == d.backend_batches
    assert all(any(_inside(p, o) for o in scans) for p in passes)
    # stage names carry no id; the dispatch parts nest in the step
    assert all("/" not in s[0] for s in spans if s[0][5:] in TOP + DISPATCH)
    steps = [s for s in spans if s[0] == "slam.frontend_step"]
    for name in DISPATCH:
        assert all(any(_inside(s, o) for o in steps) for s in spans if s[0] == "slam." + name)


def test_async_worker_writes_its_pass_spans(corridor_log, tmp_path):
    eng = _engine(corridor_log, sync=False)
    passed = []
    pass_ = eng._backend_pass

    def recorded(batch):
        passed.append(batch[-1][0])
        return pass_(batch)

    eng._backend_pass = recorded
    with trace(str(tmp_path)):
        _feed(eng, corridor_log[2], 12)
        eng.finish()
    spans = _spans(tmp_path / "trace.json")
    passes = [s for s in spans if s[0].startswith("slam.backend_pass/")]
    assert passed and sorted(int(s[0].split("/")[1]) for s in passes) == sorted(passed)
    assert passed[-1] == len(eng.store) - 1
    # the worker's passes stand alone, on its own thread
    scans = [s for s in spans if s[0].startswith("slam.scan/")]
    assert {p[3] for p in passes}.isdisjoint({s[3] for s in scans})
    for p in passes:
        inner = [s for s in spans if s[0] in ("slam.backend_update", "slam.backend_loop_closure")
                 and _inside(s, p)]
        assert len(inner) == 2


def test_stage_span_cost_and_accounting():
    timers = StageTimers()
    with timers.stage("a"):
        with timers.stage("b"):
            pass
    with pytest.raises(ValueError):
        with timers.stage("a"):
            raise ValueError
    st = timers.as_dict()
    assert st["a"]["count"] == 2 and st["b"]["count"] == 1
    assert st["b"]["total_s"] <= st["a"]["total_s"]
    # an entry never entered closes nothing
    timers.stage("c").__exit__(None, None, None)
    assert "c" not in timers.stages
    # no profiler: the root span is a shared null context
    assert timers.root("scan", 3) is timers.root("backend_pass", 4)
    # device timing off, or on CPU tensors: no pair
    assert timers.device_start(torch.device("cpu")) is None
    timers.device_timing = True
    assert timers.device_start(torch.device("cpu")) is None
    timers.device_stop(None, "device.step")
    timers.device_resolve()
    assert not [k for k in timers.stages if k.startswith("device.")]


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_gaps_are_named_by_the_innermost_program_span():
    """``scripts/torch_stage_spans.py`` names a traced slice's idle gaps by
    the innermost ``slam.`` span holding the gap's middle, its id cut off,
    and by the harness's span where no program span holds it."""
    trace = {"traceEvents": [
        _x("slambench.slice", 0, 1000),
        _x("slambench.process", 0, 400), _x("slambench.process", 500, 400),
        _x("slam.scan/7", 0, 400), _x("slam.frontend_step", 10, 200),
        _x("slam.frontend_fetch", 150, 60),
        _x("slam.backend_pass/5", 220, 170), _x("slam.backend_loop_closure", 230, 150),
        _x("k", 0, 10, "kernel"), _x("k", 210, 10, "kernel"), _x("k", 390, 10, "kernel"),
        _x("k", 450, 10, "kernel"), _x("k", 990, 10, "kernel")]}
    gaps = dict((round(s * 1e6), name) for name, s in stage_spans.name_gaps(trace))
    # 10-210: the step's middle (110) lies in frontend_step only; 220-390:
    # the closure stage, inside the pass, inside the scan; 400-450: no
    # program span, no harness span but the slice: "harness"; 460-990: the
    # harness's second process span (the program's spans end at 400)
    assert gaps == {200: "frontend_step", 170: "backend_loop_closure", 50: "harness",
                    530: "process"}


def test_span_metrics_from_the_totals():
    ctx = {"fed": 10, "durations": [0.005] * 10, "totals": {
        "solve_time_s": 0.01, "fused_rows_run": 8, "fused_rows_used": 2,
        "cg_steps_needed": 1500, "cg_steps_run": 5000,
        "stage.ingest.n": 10, "stage.ingest.s": 0.004,
        "stage.frontend_prepare.n": 9, "stage.frontend_prepare.s": 0.003,
        "stage.frontend_step.n": 9, "stage.frontend_step.s": 0.02,
        "stage.frontend_commit.n": 9, "stage.frontend_commit.s": 0.006,
        "stage.backend_update.n": 6, "stage.backend_update.s": 0.002,
        "stage.backend_loop_closure.n": 6, "stage.backend_loop_closure.s": 0.0145,
        "stage.device.step.n": 8, "stage.device.step.s": 0.012,
        "stage.device.solve.n": 0, "stage.device.solve.s": 0.0}}
    m = stage_spans.span_metrics(ctx, copies_s=0.0005)
    assert m["ingest.ms_per_scan"] == pytest.approx(0.4)
    assert m["engine.prepare_ms_per_scan"] == pytest.approx(0.3)
    assert m["engine.commit_ms_per_scan"] == pytest.approx(0.6)
    # 50 ms of calls less (49.5 ms of stages less the 0.5 ms of copies)
    assert m["engine.unspanned_ms_per_scan"] == pytest.approx(0.1)
    assert m["backend.pass_ms_per_scan"] == pytest.approx(0.6)
    assert m["backend.fused_useful_frac"] == 0.25
    assert m["step_graph.device_ms_per_step"] == pytest.approx(1.5)
    assert "closure.solve_device_ms" not in m
    assert m["closure.cg_useful_frac"] == 0.3


def test_closure_split_by_capture():
    """``closure_split`` parts the closure calls into those that captured a
    solve program and those that did not, and gives the mean and median of
    all of them."""
    rows = [{"ms": 300.0, "captured": [["solve_64x128", 1]], "capture_ms": 90.0},
            {"ms": 100.0, "captured": [], "capture_ms": 0.0},
            {"ms": 150.0, "captured": [], "capture_ms": 0.0},
            {"ms": 170.0, "captured": [], "capture_ms": 0.0}]
    out = stage_spans.closure_split(rows)
    assert out["capture"] == {"n": 1, "mean_ms": 300.0, "median_ms": 300.0,
                              "capture_ms_mean": 90.0}
    assert out["no_capture"] == {"n": 3, "mean_ms": 140.0, "median_ms": 150.0,
                                 "capture_ms_mean": 0.0}
    assert out["all_mean_ms"] == 180.0 and out["all_median_ms"] == 160.0
    assert out["capture_share"] == 0.25
    empty = stage_spans.closure_split([])
    assert empty["all_mean_ms"] is None and empty["no_capture"]["n"] == 0
