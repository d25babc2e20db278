"""Port vs JAX package: base types (config, Pose2 algebra, scan packing,
map specs). Inputs are made with numpy from a seed and handed to both."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.config as jcfg
import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.models.scan as jscan
import roborts_slam_tpu.utils.geometry as jgeo
import roborts_slam_tpu_torch.config as tcfg
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.models.scan as tscan
import roborts_slam_tpu_torch.utils.geometry as tgeo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")

# f32 elementwise algebra on O(10) values: a few ulp (cos/sin of the two
# frameworks differ by an ulp, products of magnitude ~10 double it)
ALGEBRA_TOL = 5e-6


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-10, 10, (n, 2)),
                           rng.uniform(-3.1, 3.1, (n, 1))], 1).astype(np.float32)


def _both(jfn, tfn, *arrays):
    want = jfn(*[jnp.asarray(a) for a in arrays])
    got = tfn(*[torch.as_tensor(a) for a in arrays])
    return want, got


def test_config_defaults_equal():
    assert dataclasses.asdict(tcfg.SlamConfig()) == dataclasses.asdict(jcfg.SlamConfig())


def test_load_config_simulation_yaml_field_for_field():
    j = dataclasses.asdict(jcfg.load_config(SIM_YAML, max_points=1152, world_size=30.0))
    t = dataclasses.asdict(tcfg.load_config(SIM_YAML, max_points=1152, world_size=30.0))
    assert j == t
    assert t["use_optimize_scan_match"] is False and t["fine_map_resolution"] == 0.01


@pytest.mark.parametrize("sigma,res", [(0.03, 0.01), (0.4, 0.1), (0.05, 0.02),
                                       (0.001, 0.01), (1.0, 0.05)])
def test_gaussian_kernel_half_size(sigma, res):
    assert (tcfg.gaussian_kernel_half_size(sigma, res)
            == jcfg.gaussian_kernel_half_size(sigma, res))


@pytest.mark.parametrize("name", ["pose_compose", "pose_relative",
                                  "squared_distance"])
def test_binary_pose_ops(name):
    a, b = _poses(0), _poses(1)
    want, got = _both(getattr(jgeo, name), getattr(tgeo, name), a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ALGEBRA_TOL * 20)


@pytest.mark.parametrize("name", ["pose_inverse", "normalize_angle"])
def test_unary_pose_ops(name):
    a = _poses(2) * (3.0 if name == "normalize_angle" else 1.0)
    want, got = _both(getattr(jgeo, name), getattr(tgeo, name), a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ALGEBRA_TOL * 4)


def test_transform_points_and_bound_box():
    rng = np.random.default_rng(3)
    poses = _poses(3, 5)
    pts = rng.uniform(-8, 8, (5, 40, 2)).astype(np.float32)
    mask = rng.random((5, 40)) > 0.3
    want, got = _both(jgeo.transform_points, tgeo.transform_points, poses, pts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ALGEBRA_TOL * 4)
    (jmn, jmx), (tmn, tmx) = _both(jgeo.points_bound_box, tgeo.points_bound_box,
                                   pts, mask)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    inside = rng.uniform(-9, 9, (5, 2)).astype(np.float32)
    want = jgeo.bound_box_contains(jmn, jmx, jnp.asarray(inside))
    got = tgeo.bound_box_contains(tmn, tmx, torch.as_tensor(inside))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predict_pose_by_odom_and_change_gate():
    a, b, c = _poses(4), _poses(5), _poses(6)
    want, got = _both(jgeo.predict_pose_by_odom, tgeo.predict_pose_by_odom, a, b, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ALGEBRA_TOL * 20)
    near = a + np.random.default_rng(7).normal(0, 0.08, a.shape).astype(np.float32)
    want = jgeo.pose_change_enough(jnp.asarray(a), jnp.asarray(near), 0.1, 0.01745)
    got = tgeo.pose_change_enough(torch.as_tensor(a), torch.as_tensor(near), 0.1, 0.01745)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("log", ["golden_icra", "golden_willow"])
def test_ranges_to_packed_equal(log):
    d = np.load(os.path.join(REPO, "tests", "data", f"{log}.npz"))
    jl = jscan.LaserModel.from_array(d["laser"])
    tl = tscan.LaserModel.from_array(d["laser"])
    assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    assert jl.range_threshold == tl.range_threshold
    for i in (0, 7, len(d["times"]) - 1):
        jp, jm, jn = jscan.ranges_to_packed(d["ranges"][i], jl, 1152)
        tp, tm, tn = tscan.ranges_to_packed(d["ranges"][i], tl, 1152)
        assert jn == tn
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jm, tm)


def test_pack_points_overflow_raises():
    pts = np.zeros((9, 2), np.float32)
    with pytest.raises(ValueError):
        tscan.pack_points(pts, 8)
    p, m, n = tscan.pack_points(pts[:5] + 1, 8)
    jp, jm, jn = jscan.pack_points(pts[:5] + 1, 8)
    assert n == jn == 5
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("world,rmax,over", [
    (30.0, 10.0, dict(max_points=1152)),            # the full-width slice
    (24.0, 8.0, dict(fine_map_resolution=0.02)),
    (12.0, 8.0, dict(fine_map_resolution=0.05, coarse_map_resolution=0.2)),
])
def test_map_specs_equal(world, rmax, over):
    jc = jcfg.load_config(SIM_YAML, **over)
    tc = tcfg.load_config(SIM_YAML, **over)
    pairs = [
        (jgm.pub_map_spec(jc, rmax, world), tgm.pub_map_spec(tc, rmax, world)),
        *zip(jgm.scan_match_map_specs(jc, world, coverage_m=rmax + 2.0),
             tgm.scan_match_map_specs(tc, world, coverage_m=rmax + 2.0)),
        *zip(jgm.backend_map_specs(jc, rmax), tgm.backend_map_specs(tc, rmax)),
    ]
    for j, t in pairs:
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.inv_res == t.inv_res
        if hasattr(j, "kernel_half"):
            assert j.kernel_half == t.kernel_half
            np.testing.assert_array_equal(j.blur_kernel(), t.blur_kernel())
    if world == 30.0:
        assert (pairs[2][1].height, pairs[1][1].height, pairs[0][1].height,
                pairs[4][1].height) == (3072, 384, 640, 2432)


def test_world_map_affine_and_count_states():
    rng = np.random.default_rng(8)
    off = np.array([6.4, 3.2], np.float32)
    poses = _poses(9, 16)
    want = jgm.world_to_map_pose(jnp.asarray(off), 50.0, jnp.asarray(poses))
    got = tgm.world_to_map_pose(torch.as_tensor(off), 50.0, torch.as_tensor(poses))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jgm.map_to_world_pose(jnp.asarray(off), 50.0, want)
    got = tgm.map_to_world_pose(torch.as_tensor(off), 50.0, got)
    # x / inv_res - offset: one f32 division and subtraction each
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    passes = (rng.random((32, 32)) * 6).astype(np.float32)
    hits = (passes * (rng.random((32, 32)) > 0.6)).astype(np.float32)
    jm = jgm.CountMap(jnp.asarray(hits), jnp.asarray(passes), jnp.asarray(off))
    tm = tgm.CountMap(torch.as_tensor(hits), torch.as_tensor(passes), torch.as_tensor(off))
    np.testing.assert_array_equal(tgm.count_map_states(tm, 3.0, 0.2).numpy(),
                                  np.asarray(jgm.count_map_states(jm, 3.0, 0.2)))
    np.testing.assert_array_equal(tgm.count_map_probs(tm).numpy(),
                                  np.asarray(jgm.count_map_probs(jm)))


@pytest.mark.parametrize("shift", [(3, -5), (0, 0), (-40, 2), (100, 100)])
def test_shift_prob_map(shift):
    rng = np.random.default_rng(10)
    spec_j = jgm.ProbMapSpec(0.05, 64, 64, 0.1, 0.72)
    spec_t = tgm.ProbMapSpec(0.05, 64, 64, 0.1, 0.72)
    probs = rng.random((64, 64)).astype(np.float32)
    off = np.array([1.6, 1.6], np.float32)
    want = jgm.shift_prob_map(spec_j, jgm.ProbMap(jnp.asarray(probs), jnp.asarray(off)), shift)
    got = tgm.shift_prob_map(spec_t, tgm.ProbMap(torch.as_tensor(probs), torch.as_tensor(off)), shift)
    np.testing.assert_array_equal(got.probs.numpy(), np.asarray(want.probs))
    np.testing.assert_allclose(got.offset.numpy(), np.asarray(want.offset), atol=1e-6)
