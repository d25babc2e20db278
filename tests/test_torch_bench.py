"""Port vs JAX package: the benchmark (``bench/``) and the roofline of
``utils/profiling.py``. The same inputs go through the JAX functions and the
port's: the headline workload (JAX's config loader handed the same
tier-adjusted config), candidate scoring against the serial NumPy oracle,
the K-slope timing under one fake clock, the roofline report under the same
peaks; the port's cost model against a brute-force count; and the headline
itself on the CPU at a tiny K."""

import dataclasses
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.bench.cpu_reference as jref
import roborts_slam_tpu.bench.timing as jtiming
import roborts_slam_tpu.bench.workload as jworkload
import roborts_slam_tpu.config as jconfig
import roborts_slam_tpu.ops.correlative as jc
import roborts_slam_tpu.utils.profiling as jprof
import roborts_slam_tpu_torch.bench.cpu_reference as tref
import roborts_slam_tpu_torch.bench.timing as ttiming
import roborts_slam_tpu_torch.ops.correlative as tc
import roborts_slam_tpu_torch.utils.profiling as tprof
from roborts_slam_tpu.models.grid_map import ProbMapSpec as JSpec
from roborts_slam_tpu_torch.bench import headline, roofline, workload
from roborts_slam_tpu_torch.config import load_config
from roborts_slam_tpu_torch.frontend.matchers import MatcherParams
from roborts_slam_tpu_torch.models.grid_map import ProbMapSpec

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
# f32 rounding of a mean of <= 200 probabilities in [0, 1]
F32_TOL = 1e-5
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "rep_times_s", "rep_spread",
               "match_us", "hbm_frac_of_peak", "achieved_gbps", "gops_per_s"}


def test_headline_workload_matches_jax(monkeypatch):
    """JAX's ``headline_workload`` with its config loader handed the same
    tier-adjusted ``configs/simulation.yaml`` (the YAML it names is not in
    the repository): every array, spec and tier equal to the port's."""
    jcfg = jconfig.load_config(str(workload.CONFIG), **workload.TIER_OVERRIDES)
    monkeypatch.setattr(jconfig, "load_config", lambda *a, **k: jcfg)
    jw = jworkload.headline_workload()
    tw = workload.headline_workload(device="cpu")
    assert set(jw) == set(tw)
    assert dataclasses.asdict(jw["cfg"]) == dataclasses.asdict(tw["cfg"])
    for tier in ("coarse", "fine", "super_fine"):
        jt, tt = getattr(jw["matcher"], tier), getattr(tw["matcher"], tier)
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
        assert (jt.n_angles, jt.n_space, jt.max_samples) == (tt.n_angles, tt.n_space,
                                                             tt.max_samples)
    for spec in ("fine_spec", "coarse_spec"):
        for f in ("resolution", "height", "width", "deviation", "blur_offset",
                  "default_prob"):
            assert getattr(jw[spec], f) == getattr(tw[spec], f), (spec, f)
    for key in ("fine_probs", "coarse_probs", "offset", "coff", "points", "mask",
                "init_pose"):
        assert tw[key].device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(jw[key]), tw[key].numpy(), err_msg=key)
    assert isinstance(tw["n_valid"], int) and tw["n_valid"] == int(jw["n_valid"]) == 1081
    # the tiers of native/baseline_correlative.cpp:41-45
    shapes = {t: (p.n_angles, p.max_samples, p.n_space) for t, p in
              (("coarse", tw["matcher"].coarse), ("fine", tw["matcher"].fine),
               ("super_fine", tw["matcher"].super_fine))}
    assert shapes == {"coarse": (30, 200, 13), "fine": (11, 200, 11),
                      "super_fine": (21, 200, 3)}


def test_headline_workload_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workload.headline_workload()


def _well_placed_scan(rng, spec, tiers, center, n_points, margin=1e-4):
    """``n_points`` points (m, sensor frame) whose every rotated and shifted
    sample lies at least ``margin`` cells from a cell edge for every tier's
    angles and offsets, in double precision: there the serial oracle (double)
    and the batched scoring (f32) take the same cell, and agree to the f32
    rounding of the sums. A sample on an edge may rightly go either way."""
    inv = spec.inv_res
    keep = []
    while len(keep) < n_points:
        p = rng.uniform(-1.6, 1.6, 2)
        ok = True
        for t in tiers:
            ang = center[2] - t.search_angle_offset + np.arange(t.n_angles) \
                * t.search_angle_resolution
            steps = np.arange(t.n_space) * t.search_space_resolution * inv
            for c0, rot in ((center[0], np.cos(ang) * p[0] - np.sin(ang) * p[1]),
                            (center[1], np.sin(ang) * p[0] + np.cos(ang) * p[1])):
                pos = (rot * inv)[:, None] + c0 - t.search_space_size * inv * 0.5 \
                    + steps[None] + 0.5
                frac = pos - np.floor(pos)
                ok &= bool(np.all((frac > margin) & (frac < 1 - margin)))
        if ok:
            keep.append(p)
    pts = np.zeros((128, 2), np.float32)
    pts[:n_points] = np.asarray(keep, np.float32)
    mask = np.zeros(128, bool)
    mask[:n_points] = True
    return pts, mask


@pytest.mark.parametrize("tier", ["coarse", "fine", "super_fine"])
def test_scores_match_serial_oracle_and_jax(tier):
    """The port's ``score_candidates`` (plain path, CPU tensors) against its
    own copy of the serial oracle and against JAX's ``score_candidates``, on a
    96² map at 0.05 m with the headline's tiers; the scan reaches past the
    map's high edges (out-of-map samples add the default probability)."""
    cfg = load_config(str(workload.CONFIG), **workload.TIER_OVERRIDES)
    matcher = MatcherParams.from_config(cfg, use_center_penalty=True)
    tiers = (matcher.coarse, matcher.fine, matcher.super_fine)
    p = getattr(matcher, tier)
    kw = dict(resolution=0.05, height=96, width=96, deviation=0.1, blur_offset=0.72)
    spec, jspec = ProbMapSpec(**kw), JSpec(**kw)
    rng = np.random.default_rng(8)
    probs = rng.uniform(0, 1, (96, 96)).astype(np.float32)
    center = np.array([80.3, 71.6, 0.4], np.float32)      # scan spills past x, y = 95
    n = 60
    pts, mask = _well_placed_scan(rng, spec, tiers, center.astype(np.float64), n)

    t_scores, t_ang, t_xs, t_ys = tc.score_candidates(
        spec, p, torch.as_tensor(probs), torch.zeros(2), torch.as_tensor(pts),
        torch.as_tensor(mask), n, torch.as_tensor(center))
    j_scores, *_ = jc.score_candidates(
        jspec, jc.CorrelativeParams(**dataclasses.asdict(p)), jnp.asarray(probs),
        jnp.zeros(2), jnp.asarray(pts), jnp.asarray(mask), n, jnp.asarray(center))
    s_scores, s_ang, s_xs, s_ys = tref.score_candidates_serial(
        probs, spec.default_prob, spec.inv_res, pts, n, center.astype(np.float64),
        p.search_space_size, p.search_space_resolution, p.search_angle_offset,
        p.search_angle_resolution, p.use_point_size)
    assert t_scores.shape == (p.n_angles, p.n_space, p.n_space)
    assert (t_scores > 0).all()
    np.testing.assert_allclose(t_scores.numpy(), s_scores, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(t_ang.numpy(), s_ang, atol=1e-5)
    np.testing.assert_allclose(t_xs.numpy(), s_xs, atol=1e-4)
    # out-of-map samples were scored: a sample lies past the edge
    assert (s_xs[-1] + 1.6 / spec.resolution) > spec.width


def test_cpu_reference_is_the_jax_copy():
    """The port's oracle is a copy, not an import, and computes the same."""
    assert tref.__file__ != jref.__file__
    rng = np.random.default_rng(3)
    scores = rng.uniform(0, 1, (5, 4, 4))
    scores[0, 0, 0] = 0.0
    angles, xs, ys = rng.uniform(-1, 1, 5), rng.uniform(0, 9, 4), rng.uniform(0, 9, 4)
    c = np.array([4.0, 5.0, 0.2])
    for fn in ("penalize_serial", "find_best_serial"):
        args = ((scores, angles, xs, ys, c, 0.05, 0.6, 0.4) if fn == "penalize_serial"
                else (scores, angles, xs, ys))
        got, want = getattr(tref, fn)(*args), getattr(jref, fn)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)


class _Clock:
    """A fake ``time.perf_counter`` that the fake workload advances."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("which", ["k_slope", "k_slope_dynamic"])
def test_k_slope_matches_jax(monkeypatch, which):
    """Both slopes on one fake workload (a fixed cost, a cost per iteration
    and a jitter that depends on the seed) under a fake clock: the port's
    protocol gives JAX's slope, and the workload's cost per iteration."""
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)

    def f(seed, K):
        clock.t += 0.025 + 0.002 * K + 1e-4 * (seed % 3)
        return np.float32(K)

    if which == "k_slope":
        make = lambda K: (lambda seed: f(seed, K))
        got = ttiming.k_slope(make, k_points=(8, 40), reps=3)
        want = jtiming.k_slope(make, k_points=(8, 40), reps=3)
        assert got == want
    else:
        got, gd = ttiming.k_slope_dynamic(f, k_points=(8, 40), reps=3)
        want, wd = jtiming.k_slope_dynamic(f, k_points=(8, 40), reps=3)
        assert got == want and gd == wd
    assert got == pytest.approx(0.002, abs=1e-9)


@pytest.mark.parametrize("kind", [H100, "cpu"])
@pytest.mark.parametrize("seconds,flops,bytes_moved", [
    (1e-3, 5e9, 1e6),           # bound by the arithmetic
    (2e-4, 1e6, 4e8),           # bound by memory
])
def test_roofline_report_matches_jax(monkeypatch, kind, seconds, flops, bytes_moved):
    """``roofline_report`` against JAX's, with the port's H100 entry put into
    JAX's table: equal dicts (the same keys and arithmetic)."""
    monkeypatch.setitem(jprof.DEVICE_PEAKS, H100, tprof.DEVICE_PEAKS[H100])
    got = tprof.roofline_report("k", seconds, flops, bytes_moved, device_kind=kind)
    want = jprof.roofline_report("k", seconds, flops, bytes_moved, device_kind=kind)
    assert got == want
    assert got["device"] == kind


def test_device_peaks_are_the_cards_and_unknown_raises():
    """The H100's data-sheet peaks, no TPU entry, and an unknown device
    raises instead of borrowing another's peaks; without a card the current
    device cannot be named."""
    assert tprof.DEVICE_PEAKS[H100] == {"bf16_tflops": 989.0, "f32_tflops": 67.0,
                                        "hbm_gbps": 3350.0, "power_limit_w": 700.0}
    assert not [k for k in tprof.DEVICE_PEAKS if "TPU" in k]
    for kind in ("TPU v4", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(KeyError):
            tprof.roofline_report("k", 1e-3, 1.0, 1.0, device_kind=kind)
        with pytest.raises(KeyError):
            roofline.bound(1.0, 1.0, device_kind=kind)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.roofline_report("k", 1e-3, 1.0, 1.0)
    assert roofline.bound(3.35e9, 1.0, H100) == pytest.approx((1.0, "bytes"))
    assert roofline.bound(1.0, 6.7e10, H100) == pytest.approx((1.0, "operations"))


def _brute_force(fine_spec, matcher, pts, n_valid, pose, offset, batch):
    """Operations and distinct cells of each tier, counted one (map,
    angle, sample, candidate) at a time in f32, as the scoring computes
    the cell: floor(rotated sample + candidate offset + 0.5)."""
    f32 = np.float32
    out = []
    center = [f32((pose[0] + offset[0]) / f32(fine_spec.resolution)),
              f32((pose[1] + offset[1]) / f32(fine_spec.resolution)), f32(pose[2])]
    for p in (matcher.coarse, matcher.fine, matcher.super_fine):
        use = p.use_point_size
        step = 1 if n_valid < 2 * use else n_valid // (use - 1)
        samples = [i * step for i in range(p.max_samples) if i * step < n_valid]
        cells, ops = set(), 0
        for b in range(batch):
            for a in range(p.n_angles):
                ang = f32(f32(center[2] - f32(p.search_angle_offset))
                          + f32(a) * f32(p.search_angle_resolution))
                c, s = np.cos(ang), np.sin(ang)
                for i in samples:
                    px, py = pts[i] * f32(fine_spec.inv_res)
                    rx, ry = f32(c * px - s * py), f32(s * px + c * py)
                    for kx in range(p.n_space):
                        x = f32(center[0] - f32(f32(p.search_space_size * fine_spec.inv_res)
                                                * f32(0.5))) \
                            + f32(kx) * f32(p.search_space_resolution * fine_spec.inv_res)
                        gx = math.floor(f32(f32(rx + x) + f32(0.5)))
                        for ky in range(p.n_space):
                            y = f32(center[1] - f32(f32(p.search_space_size
                                                        * fine_spec.inv_res) * f32(0.5))) \
                                + f32(ky) * f32(p.search_space_resolution * fine_spec.inv_res)
                            gy = math.floor(f32(f32(ry + y) + f32(0.5)))
                            ops += 1
                            if 0 <= gx < fine_spec.width and 0 <= gy < fine_spec.height:
                                cells.add((b, gy, gx))
        N = p.n_space
        out.append((len(cells), batch * p.n_angles * len(samples) * (N * N + 4 * N),
                    ops // (N * N)))
    return out


@pytest.mark.parametrize("batch", [1, 2])
def test_scan_match_cost_against_brute_force(batch):
    """``scan_match_cost``: per tier the distinct cells, the operations
    B·A·S_valid·(N² + 4N) and the bytes, against a count one sample at a time,
    on a 40 × 48 map (not square) that the scan leaves on two sides."""
    cfg = load_config(str(workload.CONFIG),
                      coarse_search_space_size=0.2, coarse_search_space_resolution=0.05,
                      coarse_search_angle_offset=0.1, coarse_search_angle_resolution=0.05,
                      coarse_use_point_size=10,
                      fine_search_space_size=0.1, fine_search_space_resolution=0.02,
                      fine_search_angle_offset=0.05, fine_search_angle_resolution=0.025,
                      fine_use_point_size=10,
                      super_fine_search_space_size=0.02,
                      super_fine_search_space_resolution=0.01,
                      super_fine_search_angle_offset=0.01,
                      super_fine_search_angle_resolution=0.005,
                      super_fine_use_point_size=10)
    matcher = MatcherParams.from_config(cfg, use_center_penalty=True)
    spec = ProbMapSpec(resolution=0.05, height=40, width=48, deviation=0.1,
                       blur_offset=0.72)
    rng = np.random.default_rng(5)
    n_valid = 47
    pts = np.zeros((64, 2), np.float32)
    pts[:n_valid] = rng.uniform(-1.5, 1.5, (n_valid, 2)).astype(np.float32)
    pose = np.array([0.4, 0.3, 0.2], np.float32)
    offset = np.array([0.6, 0.5], np.float32)        # map centre (1.2, 1.0) m - pose
    cost = roofline.scan_match_cost(matcher, spec, torch.as_tensor(pts), n_valid,
                                    torch.as_tensor(pose), torch.as_tensor(offset),
                                    batch=batch)
    want = _brute_force(spec, matcher, pts, n_valid, pose, offset, batch)
    for t, (cells, ops, per_map) in zip(cost.tiers, want):
        N, A, S = t.n_space, t.n_angles, t.samples
        assert per_map == batch * A * t.valid_samples
        assert (t.cells, t.operations) == (cells, ops), t.name
        assert 0 < t.cells < batch * spec.height * spec.width
        assert t.hbm_bytes == (cells * 4 + 2 * batch * A * S * 4 + batch * S
                               + 2 * batch * N * 4 + batch * 4 + batch * A * N * N * 4)
    assert cost.total_operations == sum(t.operations for t in cost.tiers)
    assert cost.total_hbm_bytes == sum(t.hbm_bytes for t in cost.tiers)
    assert json.loads(json.dumps(cost.as_dict()))["tiers"][0]["name"] == "coarse"


def test_roofline_summary_fields():
    """``roofline_summary``'s keys where JAX's carry over, from the measured
    time and the H100's peaks; the bound is the larger of the two times."""
    t = roofline.TierCost("coarse", 1, 2, 3, 4, 4, 10, 1.34e8, 3.35e6)
    cost = roofline.MatchCost(tiers=(t,), total_operations=1.34e8, total_hbm_bytes=3.35e6)
    s = roofline.roofline_summary(cost, 2e-3, device_kind=H100)
    assert s["match_us"] == pytest.approx(2000.0)
    assert s["achieved_gbps"] == pytest.approx(3.35e6 / 2e-3 / 1e9)
    assert s["hbm_frac"] == pytest.approx(s["achieved_gbps"] / 3350.0)
    assert s["ops_frac"] == pytest.approx(1.34e8 / 2e-3 / 67e12)
    assert s["bound_us"] == pytest.approx(2.0) and s["bound_by"] == "operations"


@pytest.mark.parametrize("batch", [1, 2])
def test_headline_on_the_cpu(batch):
    """The headline on CPU tensors at K = (1, 2), one rep: a record with the
    JAX bench's keys, finite, from the plain path, naming the CPU as its
    device; the baseline is built into the port's build directory."""
    rec = headline.headline(k_points=(1, 2), reps=1, batch=batch, device="cpu")
    assert RECORD_KEYS <= set(rec)
    assert rec["metric"] == "correlative_scan_match_throughput"
    assert rec["unit"] == "scans/sec/chip" and rec["device"] == "cpu"
    assert rec["batch"] == batch and rec["corr_kernel"] is None
    for k in ("value", "vs_baseline", "match_us", "hbm_frac_of_peak", "achieved_gbps",
              "gops_per_s", "baseline_scans_per_sec"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["value"] == pytest.approx(1e6 * batch / rec["match_us"])
    assert set(rec["rep_times_s"]) == {"1", "2"}
    assert headline.baseline_binary().parent.name == "_build"


def test_match_chain_is_sequential():
    """Each match of the chain starts from the previous match's pose: K = 2
    is the sum of a first match and a second from its pose (+ 0 · 1e-6)."""
    from roborts_slam_tpu_torch.frontend.matchers import scan_match

    w = workload.headline_workload(device="cpu")
    args = lambda pose: (w["matcher"], w["fine_spec"], w["fine_probs"], w["offset"],
                         w["coarse_spec"], w["coarse_probs"], w["coff"], w["points"],
                         w["mask"], w["n_valid"], pose)
    first = scan_match(*args(w["init_pose"]))
    second = scan_match(*args(first.pose))
    got = headline.match_chain(w)(0, 2)
    assert float(got) == float(first.score + second.score)
    assert float(first.score) > 0.3
