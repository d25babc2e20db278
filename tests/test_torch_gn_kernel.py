"""The Gauss-Newton match kernel (K6, ``ops/cuda/gauss_newton.cu``) and what
surrounds it.

On the CPU: the wrapper refuses tensors off the card; the launch geometry at
the front end's one map and at every chain bucket; the engine's counters of
matches, passes and fallbacks (front end in ``diag``, the chain rows the
back end takes on it) on a small run of ``SlamConfig()`` in the three step
modes, against what the plain loop's results say; the harness's small CPU run of
``default.corridor_lap``, correct against the plain reference; the two
benchmark readers on a made-up trace, and the one-pass cost worked by hand.

The CPU path (the plain loop) against the JAX package's results stored in
``tests/data/gn_kernel_jax.npz``, at the cell's shapes and the edge cases.

On the card (marked ``card``, skipped here): K6 against the plain loop at
every shape ``default.corridor_lap`` launches and at the edge cases (an
empty scan, a start off the map, a flat map, a clamped first step), within
``bench/gn_check.BARS``, and against the stored JAX results on the same
scenes, within ``gn_check.JAX_BARS``; a faulty kernel's readings fall
outside both; and ptxas reports no spills. On the card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gn_kernel.py -q -m card

(``--noconftest``: ``tests/conftest.py`` imports JAX.)"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roborts_slam_tpu_torch.backend.processor import Backend, BackendSpec
from roborts_slam_tpu_torch.bench import gn_check
from roborts_slam_tpu_torch.config import SlamConfig
from roborts_slam_tpu_torch.engine import SlamEngine
from roborts_slam_tpu_torch.frontend import matchers
from roborts_slam_tpu_torch.frontend.processor import FrontendSpec
from roborts_slam_tpu_torch.models.scan import LaserModel
from roborts_slam_tpu_torch.ops.cuda import build
from roborts_slam_tpu_torch.ops.cuda import gauss_newton as gn_kernel

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "slambench"
CONFIG = SlamConfig()
# the specs of default.corridor_lap: the derived 50 m world of a 10 m lidar
FSPEC = FrontendSpec.from_config(CONFIG, 10.0, CONFIG.derived_world_size(10.0))
BSPEC = BackendSpec.from_config(CONFIG, 10.0, FSPEC.pub_spec)
BUCKETS = Backend._BATCH_BUCKETS


def test_wrapper_refuses_cpu_tensors():
    probs, pts, msk, pose0 = gn_check.scene(FSPEC.coarse_spec, 64, None, 1, "cpu")
    with pytest.raises(ValueError, match="runs on the card"):
        gn_kernel.match(probs, pts, msk, pose0, FSPEC.coarse_spec.inv_res,
                        gn_check.params_of(CONFIG))
    assert gn_kernel.gn_launches == 0


@pytest.mark.parametrize("batch", (None,) + BUCKETS)
def test_launch_geometry(batch):
    """A block a map: the front end's one 512² map, or each chain map of a
    bucket's batch (256² maps, ``map_stride`` one map apart); 256 threads,
    five of the 1152 point slots a thread at most."""
    spec = FSPEC.coarse_spec if batch is None else BSPEC.coarse_spec
    B = batch or 1
    geo = gn_kernel.geometry(B, B, CONFIG.max_points, spec.height, spec.width)
    assert (spec.height, spec.width) == ((512, 512) if batch is None else (256, 256))
    assert geo.blocks == B and geo.threads == gn_kernel.THREADS == 256
    assert geo.map_stride == (0 if B == 1 else spec.height * spec.width)
    assert geo.points_per_thread == 5
    assert gn_kernel.geometry(B, 1, 1152, 256, 256).map_stride == 0
    with pytest.raises(ValueError):
        gn_kernel.geometry(B, B + 1, 1152, 256, 256)


# the out-and-back over the icra log with the link radius cut to 1 m: near
# chains, loop candidates and one closure in 80 scans
OUT_AND_BACK = list(range(40)) + list(range(39, -1, -1))
SMALL = CONFIG.replace(fine_map_resolution=0.02, world_size=24.0, link_scan_max_distance=1.0)


@pytest.mark.parametrize("mode", ["fused", "unfused", "pipelined"])
def test_counters_on_a_small_cpu_run(monkeypatch, mode):
    """``diag.gn_*`` count the front end's matches (one a step read),
    passes and fallbacks, the back end's ``gn_*`` the chain rows it takes:
    the real rows of its separate batches and the fused rows it uses, never
    a bucket's padding. Each equals what the plain loop's results say (its
    passes summed, its costs above ``optimize_failed_cost`` counted): row
    for row where every chain row comes from a separate batch (unfused);
    the matches, and passes and fallbacks within what the chain matches ran,
    where fused rows ride the steps."""
    torch.set_num_threads(1)
    d = np.load(ROOT / "tests" / "data" / "golden_icra.npz")
    front, chain, real, rows_run = [0, 0, 0], [], [], [0]
    opt = matchers.optimize_scan_match

    def counted(*a, **k):
        res = opt(*a, **k)
        failed = res.cost > SMALL.optimize_failed_cost
        if res.cost.dim() == 0:
            front[0] += 1
            front[1] += int(res.passes)
            front[2] += int(failed)
        else:
            chain.append((res.passes.numpy().copy(), failed.numpy().copy()))
            rows_run[0] += res.cost.numel()
        return res

    batch = Backend._batch_on_device

    def separate(self, ids, *a):
        real.append((ids >= 0).any(1))
        return batch(self, ids, *a)

    monkeypatch.setattr(matchers, "optimize_scan_match", counted)
    monkeypatch.setattr(Backend, "_batch_on_device", separate)
    eng = SlamEngine(SMALL, LaserModel.from_array(d["laser"]), device="cpu",
                     fused_backend=mode != "unfused")
    eng.pipelined_fetch = mode == "pipelined"
    for k, i in enumerate(OUT_AND_BACK):
        eng.process(d["ranges"][i], d["odom"][i], 0.1 * k)
    eng.finish()
    dg, b = eng.diag, eng.backend
    assert (dg.gn_matches, dg.gn_passes, dg.gn_fallbacks) == tuple(front)
    assert dg.gn_matches == dg.scans_in - dg.scans_dropped_move == len(OUT_AND_BACK)
    assert dg.gn_passes > dg.gn_matches
    n_real = sum(int(r.sum()) for r in real)
    assert b.gn_matches == b.fused_rows_used + n_real > 0
    assert b.gn_matches <= rows_run[0]
    assert b.num_loop_closures >= 1 and b.gn_fallbacks > 0
    if mode == "unfused":
        assert b.fused_rows_run == 0 and len(chain) == len(real)
        want = [sum(int(p[r].sum()) for (p, _), r in zip(chain, real)),
                sum(int(f[r].sum()) for (_, f), r in zip(chain, real))]
        assert [b.gn_passes, b.gn_fallbacks] == want
    else:
        assert b.fused_rows_used > 0
        assert b.gn_matches < rows_run[0]           # padding, unused rows not counted
        assert b.gn_matches <= b.gn_passes <= sum(int(p.sum()) for p, _ in chain)
        assert b.gn_fallbacks <= sum(int(f.sum()) for _, f in chain)


def test_counters_survive_warm_backend():
    """``warm_backend``'s chain batches and fused steps leave the counters
    as they stood."""
    torch.set_num_threads(1)
    d = np.load(ROOT / "tests" / "data" / "golden_icra.npz")
    eng = SlamEngine(SMALL, LaserModel.from_array(d["laser"]), device="cpu")
    for k in range(3):
        eng.process(d["ranges"][k], d["odom"][k], 0.1 * k)
    eng.finish()
    dg, b = eng.diag, eng.backend
    before = (dg.gn_matches, dg.gn_passes, b.gn_matches, b.gn_passes)
    eng.warm_backend(solver_buckets=(), match_buckets=(1, 2), rebuild_buckets=())
    eng.finish()
    assert (dg.gn_matches, dg.gn_passes, b.gn_matches, b.gn_passes) == before
    assert before[0] == 3 and before[2] == 0


# the stored JAX results (tests/data/gn_kernel_jax.npz): the front end's
# map, the chain batch at each bucket (its first b maps) and the edge cases
JAX_FIXTURE = ROOT / "tests" / "data" / "gn_kernel_jax.npz"
JAX_CASES = ([("front", None)] + [("chain", b) for b in BUCKETS]
             + [(e, None) for e in ("empty", "off_map", "flat", "clamped")])


def _jax_case(name, bucket, device, **fault):
    """A stored scene on ``device`` and JAX's results on it: (spec, params,
    probs, offset, points, mask, pose, jax pose, cost, passes), the chain
    batch cut to its first ``bucket`` maps; ``fault`` laid on the params."""
    fx = np.load(JAX_FIXTURE)
    f = {k[len(name) + 1:]: fx[k] for k in fx.files if k.startswith(name + "_")}
    n = slice(None) if bucket is None else slice(0, bucket)
    side = "chain" if name == "chain" else "front"
    spec = FSPEC.coarse_spec if side == "front" else BSPEC.coarse_spec
    it, dec, mn, dist, ang = f["params"]
    params = gn_check.params_of(CONFIG, iterate_max_times=int(it), cost_decrease_threshold=dec,
                                cost_min_threshold=mn, max_update_distance=dist,
                                max_update_angle=ang)
    params = dataclasses.replace(params, **fault)
    dev = lambda a: torch.as_tensor(a, device=device)
    probs = f["probs"][n] if f["probs"].ndim == 3 else f["probs"]
    return (spec, params, dev(probs), dev(f["offset"]), dev(f["points"]), dev(f["mask"]),
            dev(f["pose"][n]), f["jax_pose"][n], f["jax_cost"][n], f["jax_passes"][n])


@pytest.mark.parametrize("name,bucket", JAX_CASES)
def test_plain_loop_against_the_stored_jax_results(name, bucket):
    """The CPU path (the plain loop) on the stored scenes gives the JAX
    package's stored pose, cost and passes within ``gn_check.JAX_BARS``:
    the fixture is of the port's own scenes and parameters."""
    torch.set_num_threads(1)
    r = gn_check.compare_jax(*_jax_case(name, bucket, "cpu"))
    assert gn_check.held_jax(r), r
    assert r["shape"][0] == (bucket or 1)


def test_harness_run_of_the_default_cell_is_correct():
    """The harness's small CPU run of ``default.corridor_lap`` (the look for
    a card skipped; the small size of ``slambench/tests/_tiny_run.py``, the
    log driven at 2 m/s so that its closure comes within the window): the
    Gauss-Newton path, coarse chain maps and all, is correct against the
    plain reference, and the run loads no JAX."""
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH / "tests")!r}, {str(BENCH)!r}, {str(ROOT)!r}]
from _tiny_run import SMALL
from lib.harness import forbidden_modules, run
small = {{**SMALL, "mix": {{**SMALL["mix"], "speed": 2.0}},
         "workload": {{**SMALL["workload"], "closure_gap_s": 60.0,
                      "samples": {{"start_steps": 2, "steps": 8, "chain_steps": 1,
                                   "closures": 1}}}}}}
rc = run(["--workload", "default.corridor_lap", "--seed", "4100000021", "--seconds", "60",
          "--trace", "0"], time.perf_counter(), small)
assert not forbidden_modules(), forbidden_modules()
sys.exit(rc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["check"]
    assert res["check"]["closures_checked"]["value"] >= 1
    assert res["check"]["chain_steps_checked"]["value"] >= 1


# ---- the benchmark's readers ----

def _slambench_path():
    for p in (str(BENCH), str(BENCH / "reference")):
        if p not in sys.path:
            sys.path.insert(0, p)


def _reader(name):
    _slambench_path()
    from lib.harness import load_reader

    return load_reader(name)


def test_one_pass_cost_by_hand():
    """One match, one pass over 1000 valid points: 24 bytes a point (four
    cells of 4 bytes, the point's 8) and the pose in and out (24); 71
    operations a point and 60 for the solve and the step; bound by bytes
    on the H100 (24,024 B over 3.35 TB/s = 7.17 ns)."""
    _slambench_path()
    from lib import gn_cost, roofline

    b, o = gn_cost.match_cost(1000)
    assert (b, o) == (1000 * 24 + 24, 1000 * 71 + 60)
    assert gn_cost.match_cost(1000, 4) == (4 * b, 4 * o)
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(b, o, kind) == pytest.approx(24024 / 3.35e12)


def _ctx(n_beams=181, max_points=256):
    """A made-up traced run: three calls of scans with every beam valid —
    the first replayed its front-end step (one launch), the second its
    front-end step and a fused chain batch of 4 (two launches), the third
    ran eagerly (not counted) — and the kernel's device time in each."""
    from roborts_slam_tpu_torch.models.scan import LaserModel as Laser

    laser = Laser(angle_min=-2.0, angle_max=2.0, range_min=0.05, range_max=10.0,
                  num_beams=n_beams, scan_time=0.025)
    ranges = np.full(n_beams, 3.0, np.float32)
    kern = "void gauss_newton_match_kernel(float const*, ...)"
    ev = [{"ph": "X", "cat": "user_annotation", "name": "slambench.slice", "ts": 0, "dur": 300},
          {"ph": "X", "cat": "user_annotation", "name": "slambench.process", "ts": 10, "dur": 50},
          {"ph": "X", "cat": "user_annotation", "name": "slambench.process", "ts": 100, "dur": 80},
          {"ph": "X", "cat": "user_annotation", "name": "slambench.process", "ts": 200, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": kern, "ts": 20, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "correlation_scores_kernel", "ts": 31, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": kern, "ts": 110, "dur": 12},
          {"ph": "X", "cat": "kernel", "name": kern, "ts": 130, "dur": 18},
          {"ph": "X", "cat": "kernel", "name": kern, "ts": 210, "dur": 40}]
    _slambench_path()
    from lib import trace

    calls = [{"i": 0, "replayed_only": True, "chains": {}, "front": True},
             {"i": 1, "replayed_only": True, "chains": {4: 1}, "front": True},
             {"i": 2, "replayed_only": False, "chains": {}, "front": True}]
    cfg = CONFIG.replace(max_points=max_points)
    return {"trace": trace.read({"traceEvents": ev}), "calls": calls, "config": cfg,
            "laser": laser, "scans": [(ranges, None, 0.0)] * 3,
            "device_kind": "NVIDIA H100 80GB HBM3"}


def test_gn_readers_on_a_made_up_trace():
    """``kernels.gn_us_per_match``: (10 + 12 + 18) µs over 1 + 5 matches;
    ``kernels.gn_roofline``: six one-pass matches of 181 valid points over
    the same 40 µs. The eager call is left out; a trace without the kernel
    (the plain loop's) gives no value."""
    ctx = _ctx()
    assert _reader("kernels.gn_us_per_match")(ctx) == pytest.approx(40.0 / 6)
    _slambench_path()
    from lib import gn_cost

    b, _ = gn_cost.match_cost(181, 6)
    want = 100.0 * (b / 3.35e12) / 40e-6
    assert _reader("kernels.gn_roofline")(ctx) == pytest.approx(want)
    assert 0 < want <= 100
    plain = dict(ctx, trace={**ctx["trace"], "dev": [d for d in ctx["trace"]["dev"]
                                                     if "gauss_newton" not in d[2]]})
    assert _reader("kernels.gn_roofline")(plain) is None
    assert _reader("kernels.gn_us_per_match")(plain) is None
    # one launch missing from the fused call: that call is left out
    short = dict(ctx, trace={**ctx["trace"], "dev": [d for d in ctx["trace"]["dev"]
                                                     if d[0] != 130]})
    assert _reader("kernels.gn_us_per_match")(short) == pytest.approx(10.0)


# ---- on the card ----

@pytest.fixture
def card():
    """The card, or a skip where there is none or no ``nvcc``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    try:
        build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda", 0)


# (batch, map spec): the shapes default.corridor_lap launches K6 at
CELL_SHAPES = [(None, "front")] + [(b, "chain") for b in BUCKETS]


@pytest.mark.card
@pytest.mark.parametrize("batch,side", CELL_SHAPES)
@pytest.mark.parametrize("seed", [11, 12])
def test_k6_against_plain_at_the_cells_shapes(card, batch, side, seed):
    spec = FSPEC.coarse_spec if side == "front" else BSPEC.coarse_spec
    probs, pts, msk, pose0 = gn_check.scene(spec, CONFIG.max_points, batch, seed, card)
    r = gn_check.compare(spec, gn_check.params_of(CONFIG), probs, pts, msk, pose0)
    print(json.dumps(r))
    assert gn_check.held(r), r
    assert max(r["passes"]) > 1


@pytest.mark.card
@pytest.mark.parametrize("case", ["empty", "off_map", "flat", "clamped"])
def test_k6_against_plain_at_the_edges(card, case):
    spec = FSPEC.coarse_spec
    probs, pts, msk, pose0, over = gn_check.edge_scenes(spec, CONFIG.max_points, card)[case]
    params = gn_check.params_of(CONFIG, **over)
    r = gn_check.compare(spec, params, probs, pts, msk, pose0)
    print(json.dumps(r))
    assert gn_check.held(r), r
    if case in ("empty", "off_map", "flat"):
        assert r["passes"] == [2]          # nothing moves: the second pass stops
    if case == "clamped":
        pose, _, _ = gn_kernel.match(probs, pts, msk, pose0, spec.inv_res, params)
        step = (pose - pose0)[0, 0].item()
        assert step == pytest.approx(CONFIG.max_update_distance * spec.inv_res, abs=1e-4)


@pytest.mark.card
@pytest.mark.parametrize("fault", [{"iterate_max_times": 1}, {"max_update_angle": 0.0}])
def test_bars_catch_a_faulty_kernel(card, fault):
    """K6 stopped after one pass, or with its angle's step dropped, against
    the sound plain loop: outside the bars on the front end's shape."""
    spec = FSPEC.coarse_spec
    probs, pts, msk, pose0 = gn_check.scene(spec, CONFIG.max_points, None, 11, card)
    params = gn_check.params_of(CONFIG)
    r = gn_check.compare(spec, params, probs, pts, msk, pose0,
                         kernel_params=gn_check.params_of(CONFIG, **fault))
    print(json.dumps({"fault": fault, **r}))
    assert not gn_check.held(r), r


@pytest.mark.card
def test_k6_captures_and_replays(card):
    """One launch inside a CUDA graph: the replay gives the eager launch's
    bits."""
    spec = BSPEC.coarse_spec
    probs, pts, msk, pose0 = gn_check.scene(spec, CONFIG.max_points, 4, 13, card)
    params = gn_check.params_of(CONFIG)
    want = gn_kernel.match(probs, pts, msk, pose0, spec.inv_res, params)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            got = gn_kernel.match(probs, pts, msk, pose0, spec.inv_res, params)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.card
@pytest.mark.parametrize("name,bucket", JAX_CASES)
def test_k6_against_the_stored_jax_results(card, name, bucket):
    """K6 through the port's ``optimize_scan_match`` on the card against the
    JAX package's stored pose, cost and passes on the same scenes (written
    on the CPU by ``scripts/torch_gn_kernel_fixture.py``), within
    ``gn_check.JAX_BARS``."""
    from roborts_slam_tpu_torch.ops.cuda import gauss_newton as k6

    before = k6.gn_launches
    r = gn_check.compare_jax(*_jax_case(name, bucket, card))
    print(json.dumps({"case": name, "bucket": bucket, **r}))
    assert k6.gn_launches == before + 1
    assert gn_check.held_jax(r), r


@pytest.mark.card
@pytest.mark.parametrize("fault", [{"iterate_max_times": 1}, {"max_update_angle": 0.0}])
def test_jax_bars_catch_a_faulty_kernel(card, fault):
    """K6 stopped after one pass, or with its angle's step dropped, against
    JAX's stored results: outside ``gn_check.JAX_BARS`` on the front end's
    scene and on the chain batch of 16."""
    for name, bucket in (("front", None), ("chain", 16)):
        r = gn_check.compare_jax(*_jax_case(name, bucket, card, **fault))
        print(json.dumps({"fault": fault, "case": name, **r}))
        assert not gn_check.held_jax(r), r


@pytest.mark.card
def test_ptxas_reports_no_spills(card):
    lines = gn_kernel.ptxas_report()
    print("\n".join(lines))
    assert any("gauss_newton_match_kernel" in ln for ln in lines), lines
    spills = [int(n) for ln in lines for n in re.findall(r"(\d+) bytes spill", ln)]
    assert spills and not any(spills), lines
