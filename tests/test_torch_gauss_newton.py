"""Port vs JAX package: the Gauss-Newton (optimize) matcher.

The same numpy inputs go through ``ops/gauss_newton.py`` of both packages:
one ``_cost_h_b`` pass (cost, H, b), the written-out 3x3 solve against
``jnp.linalg.solve``, and the whole refinement, on the box-scan cases of
``tests/test_matchers.py`` plus an empty scan, a scan wholly outside the map
and a singular ``H``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.ops.gauss_newton as jgn
import roborts_slam_tpu.ops.raster as jraster
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.gauss_newton as tgn

torch.set_num_threads(1)

SPEC = dict(resolution=0.05, height=256, width=256, deviation=0.1,
            blur_offset=0.9, default_prob=0.3)
OFFSET = np.array([6.4, 6.4], np.float32)
PARAMS = dict(iterate_max_times=20, cost_decrease_threshold=0.1,
              cost_min_threshold=0.5, max_update_distance=0.5,
              max_update_angle=0.5)
# the shipped defaults (config.py: iterate_times 10, thresholds 1.0 / 2.0)
DEFAULTS = dict(iterate_max_times=10, cost_decrease_threshold=1.0,
                cost_min_threshold=2.0, max_update_distance=0.5,
                max_update_angle=0.2)


def _box_scan(n=160, max_points=192):
    """The box scan of tests/test_matchers.py."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3.0 * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** 0.15,
                    2.0 * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** 0.15], -1)
    points = np.zeros((max_points, 2), np.float32)
    points[:n] = pts
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return points, mask


@pytest.fixture(scope="module")
def scene():
    """The map of test_gauss_newton_refines_pose, stamped by the JAX package
    and handed to both as one numpy array."""
    points, mask = _box_scan()
    jspec = jgm.ProbMapSpec(**SPEC)
    pmap = jraster.stamp_scan(jspec, jgm.make_prob_map(jspec, offset=OFFSET),
                              jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))
    return jspec, tgm.ProbMapSpec(**SPEC), np.asarray(pmap.probs), points, mask


def _both(scene, params, init, mask=None, probs=None):
    jspec, tspec, probs0, points, mask0 = scene
    mask = mask0 if mask is None else mask
    probs = probs0 if probs is None else probs
    want = jgn.optimize_scan_match(
        jspec, jgn.OptimizeParams(**params), jnp.asarray(probs),
        jnp.asarray(OFFSET), jnp.asarray(points), jnp.asarray(mask),
        jnp.asarray(init, jnp.float32))
    got = tgn.optimize_scan_match(
        tspec, tgn.OptimizeParams(**params), torch.as_tensor(probs),
        torch.as_tensor(OFFSET), torch.as_tensor(points), torch.as_tensor(mask),
        torch.as_tensor(np.asarray(init, np.float32)))
    return got, want


@pytest.mark.parametrize("pose_map", [[129.0, 127.2, 0.02], [128.0, 128.0, 0.0],
                                      [140.3, 120.9, -0.4], [3.0, 250.0, 1.0]])
def test_cost_h_b_matches_jax(scene, pose_map):
    jspec, tspec, probs, points, mask = scene
    pm = np.asarray(pose_map, np.float32)
    jc, jH, jb = jgn._cost_h_b(jspec, jnp.asarray(probs), jnp.asarray(pm),
                               jnp.asarray(points), jnp.asarray(mask))
    tc, tH, tb = tgn._cost_h_b(tspec, torch.as_tensor(probs), torch.as_tensor(pm),
                               torch.as_tensor(points), torch.as_tensor(mask))
    # sums of 160 f32 products taken in another order: 1e-5 relative
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5, atol=1e-5)
    scale = max(float(np.abs(np.asarray(jH)).max()), 1.0)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), atol=1e-5 * scale)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5 * scale)


def test_solve3_matches_linalg_solve():
    """Well-conditioned 3x3 systems: the written-out elimination agrees with
    ``jnp.linalg.solve`` (LU with partial pivoting, the same pivots) to 1e-5
    relative to the solution's size."""
    rng = np.random.default_rng(0)
    J = rng.normal(size=(32, 40, 3)).astype(np.float32)
    H = np.einsum("bpi,bpj->bij", J, J).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32) * 10
    want = np.asarray(jnp.linalg.solve(jnp.asarray(H), jnp.asarray(b)[..., None]))[..., 0]
    got = tgn.solve3(torch.as_tensor(H), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # a row order that needs pivoting: zero on the diagonal
    P = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)
    got = tgn.solve3(torch.as_tensor(P @ H[0]), torch.as_tensor(P @ b[0])).numpy()
    np.testing.assert_allclose(got, want[0], rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_solve3_singular_gives_nan_without_raising():
    H = torch.zeros(2, 3, 3)
    H[1] = torch.tensor([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 1.0, 1.0]])
    b = torch.ones(2, 3)
    out = tgn.solve3(H, b)
    assert not torch.isfinite(out).all(dim=-1).any()
    # 0/0 in the exactly singular system: NaN, the branch the optimizer takes
    assert torch.isnan(out[0]).any()


@pytest.mark.parametrize("params,init", [
    (PARAMS, [0.05, -0.04, 0.02]), (PARAMS, [0.0, 0.0, 0.0]),
    (DEFAULTS, [0.1, -0.05, 0.05]), (DEFAULTS, [-0.2, 0.15, -0.08]),
])
def test_optimize_scan_match_matches_jax(scene, params, init):
    got, want = _both(scene, params, init)
    # up to 20 GN steps, each solving a system whose f32 sums differ in the
    # last bits: pose to 2e-4 m / 2e-4 rad (a 250th of a cell), cost to 1e-3
    # relative
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=2e-4)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3, atol=1e-3)
    if init != [0.0, 0.0, 0.0]:
        assert np.abs(got.pose.numpy()).max() < np.abs(np.asarray(init)).max()


def test_empty_scan_keeps_pose_at_max_cost(scene):
    mask = np.zeros(192, bool)
    got, want = _both(scene, DEFAULTS, [0.3, -0.2, 0.1], mask=mask)
    assert float(got.cost) == float(want.cost) == tgn.K_MAX_COST
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-6)
    np.testing.assert_allclose(got.pose.numpy(), [0.3, -0.2, 0.1], atol=1e-6)


def test_all_points_outside_the_map(scene):
    """Every point off the map: J = 0, H = 1e-9·I, b = 0 — a zero step and a
    zero cost in both packages."""
    got, want = _both(scene, DEFAULTS, [50.0, 50.0, 0.3])
    assert float(got.cost) == float(want.cost) == 0.0
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)


def test_singular_h_keeps_pose_at_max_cost():
    """An exactly singular system that the 1e-9 on the diagonal cannot mend:
    one point, a map that rises by 0.25 per cell along x and y, and a
    geometry in which every number is a binary fraction (resolution 1/16,
    the point at local (2, 1) cells, the pose on a half cell). Then
    J = -(0.25, 0.25, 0.25), H = 0.0625·ones(3,3) exactly, the elimination
    meets 0/0, and the optimizer keeps its pose at ``K_MAX_COST`` — as
    ``jnp.linalg.solve`` makes the JAX optimizer do on the same input."""
    spec = dict(SPEC, resolution=0.0625)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    probs = (0.25 * (xx + yy) - 50.5).astype(np.float32)
    points = np.zeros((192, 2), np.float32)
    points[0] = [0.125, 0.0625]
    mask = np.zeros(192, bool)
    mask[0] = True
    init = np.array([6.28125, 6.28125, 0.0], np.float32)     # map (100.5, 100.5)
    zero = np.zeros(2, np.float32)
    want = jgn.optimize_scan_match(
        jgm.ProbMapSpec(**spec), jgn.OptimizeParams(**DEFAULTS), jnp.asarray(probs),
        jnp.asarray(zero), jnp.asarray(points), jnp.asarray(mask), jnp.asarray(init))
    tspec = tgm.ProbMapSpec(**spec)
    got = tgn.optimize_scan_match(
        tspec, tgn.OptimizeParams(**DEFAULTS), torch.as_tensor(probs),
        torch.as_tensor(zero), torch.as_tensor(points), torch.as_tensor(mask),
        torch.as_tensor(init))
    cost, H, b = tgn._cost_h_b(tspec, torch.as_tensor(probs),
                               torch.tensor([100.5, 100.5, 0.0]),
                               torch.as_tensor(points), torch.as_tensor(mask))
    np.testing.assert_array_equal(H.numpy(), np.full((3, 3), 0.0625, np.float32))
    np.testing.assert_array_equal(b.numpy(), np.full(3, 0.125, np.float32))
    assert float(got.cost) == float(want.cost) == tgn.K_MAX_COST
    np.testing.assert_array_equal(got.pose.numpy(), init)
    np.testing.assert_array_equal(np.asarray(want.pose), init)


def test_batched_call_equals_single_calls(scene):
    jspec, tspec, probs, points, mask = scene
    inits = np.array([[0.05, -0.04, 0.02], [0.0, 0.0, 0.0], [-0.2, 0.15, -0.08],
                      [50.0, 50.0, 0.3]], np.float32)
    maps = np.stack([probs, probs, np.roll(probs, 1, axis=0), probs])
    params = tgn.OptimizeParams(**DEFAULTS)
    args = (torch.as_tensor(OFFSET), torch.as_tensor(points), torch.as_tensor(mask))
    batch = tgn.optimize_scan_match(tspec, params, torch.as_tensor(maps), *args,
                                    torch.as_tensor(inits))
    assert batch.pose.shape == (4, 3) and batch.cost.shape == (4,)
    for i in range(4):
        one = tgn.optimize_scan_match(tspec, params, torch.as_tensor(maps[i]),
                                      *args, torch.as_tensor(inits[i]))
        # the same arithmetic per element; the batched matmul may sum in
        # another order than the single one
        np.testing.assert_allclose(batch.pose[i].numpy(), one.pose.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(batch.cost[i]), float(one.cost),
                                   rtol=1e-4, atol=1e-4)
