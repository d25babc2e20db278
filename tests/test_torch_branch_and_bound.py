"""Port vs JAX package: the branch-and-bound (beam search) matcher, on the
cases of ``tests/test_branch_and_bound.py``. The map is stamped once by the
JAX package and handed to both as one numpy array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.ops.branch_and_bound as jbb
import roborts_slam_tpu.ops.raster as jraster
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.branch_and_bound as tbb

torch.set_num_threads(1)

SPEC = dict(resolution=0.01, height=1024, width=1024, deviation=0.03,
            blur_offset=0.88)
OFFSET = np.array([5.12, 5.12], np.float32)

CASES = {
    # test_bnb_matches_exhaustive_best
    "exhaustive": (dict(search_space_size=0.32, search_space_resolution=0.01,
                        search_angle_offset=0.0698, search_angle_resolution=0.0349,
                        max_depth=3, beam_width=640, use_point_size=100),
                   [0.03, -0.02, 0.0]),
    # test_bnb_recovers_perturbed_pose
    "perturbed": (dict(search_space_size=0.4, search_space_resolution=0.01,
                       search_angle_offset=0.14, search_angle_resolution=0.0175,
                       max_depth=4, beam_width=512),
                  [0.09, -0.07, 0.05]),
    # test_bnb_low_score_keeps_pose: an empty map corner
    "low_score": (dict(search_space_size=0.16, search_space_resolution=0.01,
                       search_angle_offset=0.0349, search_angle_resolution=0.0349,
                       max_depth=2),
                  [4.5, 4.5, 0.0]),
    # a narrow beam, where the order among equal scores decides who survives
    "narrow_beam": (dict(search_space_size=0.32, search_space_resolution=0.01,
                         search_angle_offset=0.0698, search_angle_resolution=0.0349,
                         max_depth=3, beam_width=8),
                    [0.05, 0.04, 0.01]),
}


def _scan(n=160, max_points=192):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([2.4 * np.cos(t) + 0.5 * np.cos(3 * t),
                    1.8 * np.sin(t)], -1).astype(np.float32)
    points = np.zeros((max_points, 2), np.float32)
    points[:n] = pts
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return points, mask, n


@pytest.fixture(scope="module")
def scene():
    points, mask, n = _scan()
    jspec = jgm.ProbMapSpec(**SPEC)
    pmap = jraster.stamp_scan(jspec, jgm.make_prob_map(jspec, offset=OFFSET),
                              jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))
    return jspec, tgm.ProbMapSpec(**SPEC), np.array(pmap.probs), points, mask, n


@pytest.mark.parametrize("max_depth,step", [(3, 1), (4, 2), (2, 5)])
def test_max_pool_pyramid_exact(max_depth, step):
    rng = np.random.default_rng(max_depth)
    probs = rng.uniform(0, 1, (96, 160)).astype(np.float32)
    want = jbb.max_pool_pyramid(jnp.asarray(probs), max_depth, step, 0.3)
    got = tbb.max_pool_pyramid(torch.as_tensor(probs), max_depth, step, 0.3)
    assert len(got) == len(want) == max_depth + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the shifted-out border reads the default, never less
    assert float(got[-1][-1, -1]) == max(float(probs[-1, -1]), np.float32(0.3))


@pytest.mark.parametrize("case", list(CASES))
def test_bnb_scan_match_matches_jax(scene, case):
    jspec, tspec, probs, points, mask, n = scene
    kw, init = CASES[case]
    init = np.asarray(init, np.float32)
    want = jbb.bnb_scan_match(jspec, jbb.BnBParams(**kw), jnp.asarray(probs),
                              jnp.asarray(OFFSET), jnp.asarray(points),
                              jnp.asarray(mask), jnp.int32(n), jnp.asarray(init))
    got = tbb.bnb_scan_match(tspec, tbb.BnBParams(**kw), torch.as_tensor(probs),
                             torch.as_tensor(OFFSET), torch.as_tensor(points),
                             torch.as_tensor(mask), n, torch.as_tensor(init))
    # scores are sums of <= 200 map values over one divisor: f32 rounding.
    # The winning candidate is a lattice point, so the poses agree to the
    # rounding of the world<->map conversion unless two candidates tie within
    # that rounding (none does in these cases).
    assert abs(float(got.response) - float(want.response)) <= 1e-5
    np.testing.assert_allclose(got.best_map_pose.numpy(),
                               np.asarray(want.best_map_pose), atol=1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-6)
    if case == "low_score":
        assert float(got.response) <= 0.5
        np.testing.assert_allclose(got.pose.numpy(), init, atol=1e-6)
    if case == "perturbed":
        assert float(got.response) > 0.6 and np.abs(got.pose.numpy()[:2]).max() < 0.025


def test_bnb_empty_scan_and_noninteger_step(scene):
    jspec, tspec, probs, points, mask, n = scene
    kw, init = CASES["low_score"]
    init = np.asarray([0.0, 0.0, 0.0], np.float32)
    want = jbb.bnb_scan_match(jspec, jbb.BnBParams(**kw), jnp.asarray(probs),
                              jnp.asarray(OFFSET), jnp.asarray(points),
                              jnp.asarray(mask), jnp.int32(0), jnp.asarray(init))
    got = tbb.bnb_scan_match(tspec, tbb.BnBParams(**kw), torch.as_tensor(probs),
                             torch.as_tensor(OFFSET), torch.as_tensor(points),
                             torch.as_tensor(mask), 0, torch.as_tensor(init))
    assert float(got.response) == float(want.response) == 0.0
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-6)
    with pytest.raises(ValueError):
        tbb.bnb_scan_match(tspec, tbb.BnBParams(search_space_resolution=0.015),
                           torch.as_tensor(probs), torch.as_tensor(OFFSET),
                           torch.as_tensor(points), torch.as_tensor(mask), n,
                           torch.as_tensor(init))
