"""The metric arithmetic: the 95th percentile over all scans, the union of
the device's busy intervals and its idle gaps, the kernels of each call,
the roofline counts against hand-worked shapes, and the readers on a made-up
run."""

import pytest
import torch

from lib import harness, roofline, trace


def test_p95_is_the_nearest_rank_over_every_scan():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95([5, 1, 4, 2, 3] * 4) == 5        # rank ceil(0.95 * 20) = 19
    assert harness.p95(list(range(1, 21))) == 19


def test_union_gaps_and_spans():
    busy = trace.union([(0, 2, "a"), (1, 3, "b"), (5, 6, "c"), (9, 12, "d")], 0.5, 10)
    assert busy == [(0.5, 3), (5, 6), (9, 10)]
    assert trace.gaps(busy, 0.5, 10) == [(3, 5), (6, 9)]
    assert trace.gaps([], 0, 4) == [(0, 4)]
    spans = [(0, 10, "slice"), (1, 4, "process"), (4.5, 8, "finish"), (5, 6, "process")]
    assert trace.span_at(spans, 2) == "process"
    assert trace.span_at(spans, 5.5) == "process"
    assert trace.span_at(spans, 7) == "finish"
    assert trace.span_at(spans, 4.2) == "harness"


def test_cut():
    assert trace.cut([(0, 10), (12, 20)], [(2, 3), (9, 13), (15, 30)]) == [(0, 2), (3, 9), (13, 15)]
    assert trace.cut([(0, 5)], []) == [(0, 5)]
    assert trace.cut([(0, 5)], [(0, 5)]) == []


def test_the_checks_copies_are_left_out():
    t = made_up_trace()
    t["traceEvents"] += [{"ph": "X", "cat": "user_annotation", "name": "slambench.sample",
                          "ts": 54, "dur": 12}]
    r = trace.read(t)
    assert r["window_s"] == pytest.approx(88e-6)
    assert r["busy_s"] == pytest.approx((5 + 4 + 2) * 1e-6)


def made_up_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "slambench.slice", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "slambench.process", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "user_annotation", "name": "slambench.process", "ts": 50, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "void correlation_scores_kernel<1>(...)", "ts": 12, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "correlation_scores_v2_kernel", "ts": 20, "dur": 4},
          {"ph": "X", "cat": "kernel", "name": "ray_mark_beams_kernel", "ts": 31, "dur": 2},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 55, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "correlation_scores_kernel", "ts": 60, "dur": 6},
          {"ph": "X", "cat": "kernel", "name": "fill_zero_kernel", "ts": 200, "dur": 6}]
    return {"traceEvents": ev}


def test_read_a_trace():
    t = trace.read(made_up_trace())
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx((5 + 4 + 2 + 11) * 1e-6)   # 55-65 and 60-66 merge
    assert [n for n, _ in t["device_ops"]][:2] == ["Memcpy DtoH", "correlation_scores_kernel"]
    gaps = dict((round(s * 1e6), n) for n, s in t["idle_gaps"])
    assert gaps == {12: "harness", 3: "process", 7: "process", 22: "harness", 34: "harness"}
    per = trace.kernel_time_by_call(t, r"correlation_scores(_v2)?_kernel")
    assert per[0] == (pytest.approx(9e-6), 2) and per[1] == (pytest.approx(6e-6), 1)
    assert [c for _, c in trace.kernel_time_by_call(t, r"ray_mark")] == [1, 0]


def test_tier_cost_by_hand():
    # 1 angle, 2 samples at (0, 0) and (1, 0) cells, 2 x 2 candidates at 0 and 1:
    # sample 0 reads cells x in {0, 1}, y in {0, 1}; sample 1 x in {1, 2}: 6 cells
    rx = torch.tensor([[0.0, 1.0]])
    ry = torch.zeros(1, 2)
    sv = torch.tensor([True, True])
    xs = ys = torch.tensor([0.0, 1.0])
    b, o = roofline.tier_cost((10, 10), rx, ry, sv, xs, ys)
    A, S, N = 1, 2, 2
    assert o == A * 2 * (N * N + 4 * N)
    assert b == 6 * 4 + 2 * A * S * 4 + S + 2 * N * 4 + 4 + A * N * N * 4
    # a map 2 cells wide drops the column x = 2, an invalid sample reads nothing
    assert roofline.tier_cost((10, 2), rx, ry, sv, xs, ys)[0] == b - 2 * 4
    b1, o1 = roofline.tier_cost((10, 10), rx, ry, torch.tensor([True, False]), xs, ys)
    assert o1 == A * 1 * (N * N + 4 * N) and b1 == b - 2 * 4
    b4, o4 = roofline.tier_cost((10, 10), rx, ry, sv, xs, ys, batch=4)
    assert (b4, o4) == (4 * b, 4 * o)


def test_carve_cost_and_bound():
    b, o = roofline.carve_cost((1024, 1024), 1152)
    assert b == 1024 * 1024 * 4 + 1152 * 9 + 8 and o == 1152
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(3.35e9, 0, kind) == pytest.approx(1e-3)
    assert roofline.bound_s(0, 67e9, kind) == pytest.approx(1e-3)
    with pytest.raises(KeyError):
        roofline.peaks("cpu")


def test_readers_on_a_made_up_run():
    read = lambda n, ctx: harness.load_reader(n)(ctx)
    ctx = {"window_s": 10.0, "fed": 1000, "durations": [0.004] * 95 + [0.5] * 5,
           "closure_durations": [0.4, 0.6], "setup_s": 12.0, "trace": None, "calls": [],
           "totals": {"frontend_step_s": 3.0, "frontend_fetch_s": 1.0, "graph_replays": 990,
                      "eager_steps": 10, "dedistort_s": 0.5, "scans_dedistorted": 900,
                      "closure_capture_s": 0.3, "loop_closures": 2, "solve_time_s": 0.9,
                      "num_solves": 2}}
    assert read("scans_per_s", ctx) == 100.0
    assert read("scan_ms_p95", ctx) == pytest.approx(4.0)
    assert read("closure_stall_ms", ctx) == pytest.approx(500.0)
    assert read("setup_s", ctx) == 12.0
    assert read("engine.dispatch_ms_per_scan", ctx) == pytest.approx(2.0)
    assert read("engine.fetch_wait_ms_per_scan", ctx) == pytest.approx(1.0)
    assert read("step_graph.replay_frac", ctx) == pytest.approx(0.99)
    assert read("ingest.dedistort_ms_per_scan", ctx) == pytest.approx(0.5)
    assert read("closure.solve_and_correct_ms", ctx) == pytest.approx(450.0)
    assert read("closure.capture_ms", ctx) == pytest.approx(150.0)
    for name in ("device.idle_frac", "kernels.corr_roofline", "kernels.carve_roofline"):
        assert read(name, ctx) is None          # nothing to read: left out, never 0
    ctx["totals"]["scans_dedistorted"] = 0
    assert read("ingest.dedistort_ms_per_scan", ctx) is None
    ctx["closure_durations"] = []
    assert read("closure_stall_ms", ctx) is None
    ctx["trace"] = {"window_s": 2.0, "busy_s": 0.5}
    assert read("device.idle_frac", ctx) == pytest.approx(0.75)
