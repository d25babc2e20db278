"""Port vs JAX package: the correlative matcher (holds kernel K1's plain
version). The same numpy inputs go through the JAX package's plain-XLA
functions and the port's functions on CPU tensors (where the kernel wrapper
takes the plain PyTorch version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.ops.correlative as jc
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.correlative as tc
from roborts_slam_tpu.ops.pallas.correlation import score_candidates_pallas
from roborts_slam_tpu_torch.ops.cuda.correlation import correlation_scores

# the three tiers of configs/simulation.yaml against a 0.01 m fine map
TIERS = {
    "coarse": (0.8, 0.1, 1.745, 0.0349, 0.6, 100, True, 0),
    "fine": (0.2, 0.02, 0.349, 0.0349, 0.7, 100, True, 1),
    "super_fine": (0.02, 0.01, 0.0349, 0.00349, 0.7, 200, True, 2),
}
# f32 rounding of a mean of <= 400 probabilities in [0, 1]
F32_TOL = 1e-5


def _room_scan(seed, n_points, max_points=512):
    """A scan of a rectangular room with noise: structured, so that score
    grids have real peaks and plateaus."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-2.3, 2.3, n_points)
    w, h = 3.0 + rng.random(), 2.0 + rng.random()
    r = np.minimum(w / np.maximum(np.abs(np.cos(ang)), 1e-6),
                   h / np.maximum(np.abs(np.sin(ang)), 1e-6))
    r = r + rng.normal(0, 0.004, n_points)
    pts = np.zeros((max_points, 2), np.float32)
    pts[:n_points] = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    mask = np.zeros(max_points, bool)
    mask[:n_points] = True
    return pts, mask


def _stamped_map(seed, n_points=300, size=1024, res=0.01):
    """Both packages' fine map stamped with one scan at a known pose."""
    from roborts_slam_tpu.ops.raster import stamp_scan as jstamp

    kw = dict(resolution=res, height=size, width=size, deviation=0.03,
              blur_offset=0.72)
    jspec, tspec = jgm.ProbMapSpec(**kw), tgm.ProbMapSpec(**kw)
    off = np.array([size * res / 2] * 2, np.float32)
    pts, mask = _room_scan(seed, n_points)
    pose = np.array([0.2, -0.1, 0.3], np.float32)
    jmap = jstamp(jspec, jgm.make_prob_map(jspec, off), jnp.asarray(pts),
                  jnp.asarray(mask), jnp.asarray(pose))
    probs = np.array(jmap.probs)
    return jspec, tspec, probs, off, pts, mask, pose


def _score_both(tier, probs, off, pts, mask, n_valid, pose, jspec, tspec):
    jp, tp = jc.CorrelativeParams(*TIERS[tier]), tc.CorrelativeParams(*TIERS[tier])
    assert (jp.n_angles, jp.n_space, jp.max_samples) == (tp.n_angles, tp.n_space, tp.max_samples)
    jcenter = jgm.world_to_map_pose(jnp.asarray(off), jspec.inv_res, jnp.asarray(pose))
    tcenter = tgm.world_to_map_pose(torch.as_tensor(off), tspec.inv_res, torch.as_tensor(pose))
    want = jc.score_candidates(jspec, jp, jnp.asarray(probs), jnp.asarray(off),
                               jnp.asarray(pts), jnp.asarray(mask), n_valid, jcenter)
    got = tc.score_candidates(tspec, tp, torch.as_tensor(probs), torch.as_tensor(off),
                              torch.as_tensor(pts), torch.as_tensor(mask), n_valid, tcenter)
    return jp, tp, want, got


@pytest.mark.parametrize("n_valid", [300, 150, 0, 1])
@pytest.mark.parametrize("use", [100, 200])
def test_sample_indices(n_valid, use):
    ji, jv, jd = jc._sample_indices(jnp.int32(n_valid), use, 2 * use)
    ti, tv, td = tc._sample_indices(n_valid, use, 2 * use, "cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert td == float(jd)


@pytest.mark.parametrize("tier", list(TIERS))
def test_score_grid_matches_jax(tier):
    jspec, tspec, probs, off, pts, mask, pose = _stamped_map(0)
    query = pose + np.array([0.03, -0.02, 0.012], np.float32)
    jp, tp, (js, ja, jx, jy), (ts, ta, tx, ty) = _score_both(
        tier, probs, off, pts, mask, 300, query, jspec, tspec)
    assert ts.shape == (tp.n_angles, tp.n_space, tp.n_space)
    # angles / candidate offsets: one f32 multiply-add each
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    # scores agree to f32 rounding on all entries but the few where the two
    # frameworks' cos/sin differ by an ulp and flip one sample's cell; such
    # an entry moves by at most one sample's weight, 1/divisor
    diff = np.abs(ts.numpy() - np.asarray(js))
    divisor = min(tp.use_point_size, 300)
    flipped = diff > F32_TOL
    assert flipped.mean() <= 0.01, f"{flipped.sum()} of {diff.size} entries differ"
    assert diff.max() <= 1.0 / divisor + F32_TOL


def test_empty_scan_scores_zero_not_nan():
    jspec, tspec, probs, off, pts, mask, pose = _stamped_map(1)
    empty = np.zeros_like(mask)
    for tier in TIERS:
        _, _, (js, *_), (ts, *_) = _score_both(tier, probs, off, pts, empty, 0,
                                               pose, jspec, tspec)
        assert torch.isfinite(ts).all() and float(ts.abs().max()) == 0.0
        assert float(jnp.abs(js).max()) == 0.0
    res = tc.correlative_scan_match(
        tspec, tc.CorrelativeParams(*TIERS["coarse"]), torch.as_tensor(probs),
        torch.as_tensor(off), torch.as_tensor(pts), torch.as_tensor(empty), 0,
        torch.as_tensor(pose), torch.eye(3))
    assert float(res.response) == 0.0
    assert torch.isfinite(res.cov).all()
    np.testing.assert_array_equal(res.pose.numpy(), pose)


def test_pose_far_outside_map_scores_default_prob():
    jspec, tspec, probs, off, pts, mask, pose = _stamped_map(2)
    far = np.array([500.0, -400.0, 0.1], np.float32)
    _, _, (js, *_), (ts, *_) = _score_both("fine", probs, off, pts, mask, 300,
                                           far, jspec, tspec)
    # 100 samples (stride 300 // 99 = 3) of default_prob over divisor 100
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=F32_TOL)
    assert abs(float(ts.mean()) - 0.3) < 1e-5


@pytest.mark.parametrize("tier", list(TIERS))
def test_correlative_scan_match_matches_jax(tier):
    jspec, tspec, probs, off, pts, mask, pose = _stamped_map(3)
    query = pose + np.array([0.02, 0.03, -0.01], np.float32)
    jp, tp = jc.CorrelativeParams(*TIERS[tier]), tc.CorrelativeParams(*TIERS[tier])
    want = jc.correlative_scan_match(
        jspec, jp, jnp.asarray(probs), jnp.asarray(off), jnp.asarray(pts),
        jnp.asarray(mask), 300, jnp.asarray(query), jnp.eye(3), use_pallas=False)
    got = tc.correlative_scan_match(
        tspec, tp, torch.as_tensor(probs), torch.as_tensor(off),
        torch.as_tensor(pts), torch.as_tensor(mask), 300,
        torch.as_tensor(query), torch.eye(3))
    # response: a max over f32 means
    assert abs(float(got.response) - float(want.response)) <= F32_TOL
    # pose: tie-averaged over candidates in map cells (~500), times 0.01 m:
    # f32 rounding of a weighted mean of values ~5e2 is ~1e-4 cells = 1e-6 m
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=5e-6)
    np.testing.assert_allclose(got.best_map_pose.numpy(),
                               np.asarray(want.best_map_pose), atol=5e-4)
    # covariance entries are ratios of f32 sums: relative 1e-4
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov),
                               rtol=1e-4, atol=1e-9)


def test_batched_match_equals_per_map_calls():
    """The written-out batch dimension gives what one call per map gives."""
    _, tspec, probs, off, pts, mask, pose = _stamped_map(4)
    probs_b = torch.stack([torch.as_tensor(probs),
                           torch.as_tensor(np.ascontiguousarray(probs[::-1]))])
    poses = torch.as_tensor(np.stack([pose + [0.02, 0.0, 0.01],
                                      pose + [-0.01, 0.03, -0.02]]).astype(np.float32))
    tp = tc.CorrelativeParams(*TIERS["fine"])
    args = (torch.as_tensor(off), torch.as_tensor(pts), torch.as_tensor(mask), 300)
    both = tc.correlative_scan_match(tspec, tp, probs_b, *args, poses, torch.eye(3))
    for b in range(2):
        one = tc.correlative_scan_match(tspec, tp, probs_b[b], *args, poses[b],
                                        torch.eye(3))
        for x, y in zip(one, both):
            np.testing.assert_array_equal(x.numpy(), y[b].numpy())


def test_top_candidates_ties_take_lowest_index():
    scores = torch.zeros((2, 3, 3))
    scores[0, 1, 2] = scores[1, 0, 0] = scores[0, 0, 1] = 0.9     # a plateau
    angles, xs, ys = torch.arange(2.0), torch.arange(3.0), torch.arange(3.0) * 10
    top_s, top_a, top_x, top_y, valid = tc._top_candidates(
        scores, angles, xs, ys, scores > 0.5, 4)
    js, ja, jx, jy, jv = jc._top_candidates(
        jnp.asarray(scores.numpy()), jnp.asarray(angles.numpy()),
        jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()),
        jnp.asarray((scores > 0.5).numpy()), 4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    for t, j in ((top_a, ja), (top_x, jx), (top_y, jy)):
        np.testing.assert_array_equal(t.numpy()[:3], np.asarray(j)[:3])


def test_wrapper_on_cpu_is_plain_version_and_checks_nothing_else():
    _, tspec, probs, off, pts, mask, pose = _stamped_map(5)
    tp = tc.CorrelativeParams(*TIERS["super_fine"])
    center = tgm.world_to_map_pose(torch.as_tensor(off), tspec.inv_res, torch.as_tensor(pose))
    g = tc.candidate_grid(tspec, tp, torch.as_tensor(pts), 300, center)
    args = (torch.as_tensor(probs)[None], g.rx[None], g.ry[None], g.svalid[None],
            g.xs[None], g.ys[None], 0.3, torch.tensor([g.divisor]))
    np.testing.assert_array_equal(correlation_scores(*args).numpy(),
                                  tc.correlation_scores_plain(*args).numpy())
    with pytest.raises(ValueError):
        correlation_scores(torch.as_tensor(probs), *args[1:])


def test_port_within_bf16_envelope_of_interpret_mode_pallas():
    """The JAX package's Pallas kernel (interpret mode) reads a bf16 copy of
    the map; the port reads f32. On a small map the two stay within the
    documented bf16 envelope 4.6e-4 of each other."""
    rng = np.random.default_rng(6)
    kw = dict(resolution=0.02, height=1024, width=1024, deviation=0.05,
              blur_offset=0.88)
    jspec, tspec = jgm.ProbMapSpec(**kw), tgm.ProbMapSpec(**kw)
    # map values exactly representable in bf16, so only the sum order differs
    probs = (rng.integers(0, 129, (1024, 1024)) / 128.0).astype(np.float32)
    pts = rng.uniform(-3, 3, (128, 2)).astype(np.float32)
    mask = np.zeros(128, bool)
    mask[:90] = True
    pts[90:] = 0
    center = np.array([512.0, 512.0, 0.4], np.float32)
    tier = (0.2, 0.04, 0.0698, 0.0349, 0.6, 40, True, 1)
    s_pal, *_ = score_candidates_pallas(
        jspec, jc.CorrelativeParams(*tier), jnp.asarray(probs), jnp.zeros(2),
        jnp.asarray(pts), jnp.asarray(mask), 90, jnp.asarray(center), interpret=True)
    s_t, *_ = tc.score_candidates(
        tspec, tc.CorrelativeParams(*tier), torch.as_tensor(probs), torch.zeros(2),
        torch.as_tensor(pts), torch.as_tensor(mask), 90, torch.as_tensor(center))
    diff = np.abs(s_t.numpy() - np.asarray(s_pal))
    # the Pallas path forms cells as base + step*k, which rounds differently
    # at cell edges: such an entry moves by up to one sample, 1/40
    assert (diff > 4.6e-4).mean() <= 0.02, (diff > 4.6e-4).sum()
    assert diff.max() <= 1.0 / 40 + 4.6e-4
