"""Port vs JAX package: the tiered matcher, the front-end step and the
back-end chain match, at a small size (0.02 m fine map, 24 m world) on the
inputs of ``tests/data/golden_icra.npz``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu.backend.processor as jbp
import roborts_slam_tpu.frontend.matchers as jm
import roborts_slam_tpu.frontend.processor as jfp
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.backend.processor as tbp
import roborts_slam_tpu_torch.frontend.matchers as tm
import roborts_slam_tpu_torch.frontend.processor as tfp
from roborts_slam_tpu.models.scan import LaserModel, ranges_to_packed
from roborts_slam_tpu_torch.convert import STATE_KEYS, state_from_jax

# one thread: float sums are then taken in one fixed order on any machine
# (these replays amplify last-bit differences, see the tolerances below)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0, max_points=384)
N_STEPS = 12


def _jax_state_arrays(s):
    return {
        "pub_hits": s.pub.hits, "pub_passes": s.pub.passes, "pub_offset": s.pub.offset,
        "coarse_probs": s.coarse.probs, "coarse_offset": s.coarse.offset,
        "fine_probs": s.fine.probs, "fine_offset": s.fine.offset,
        "pose": s.pose, "last_map_update_pose": s.last_map_update_pose,
        "map_penalize_times": s.map_penalize_times, "scan_index": s.scan_index,
        "last_kept_odom": s.last_kept_odom,
    }


def _same_magnitude(got, want):
    ratio = float(got) / float(want)
    assert 0.1 <= ratio <= 10, ratio


# replays from other scans of the 120-scan log: start offsets (the first is
# the fixture's own)
VARIANTS = (0, 10, 20, 30, 40, 50, 60, 70)


def free_replay(start: int) -> np.ndarray:
    """Both front ends free over ``N_STEPS`` scans from ``start`` (JAX's
    jitted ``frontend_step`` and the port's, each from its own state, the
    port's first from JAX's initial state). (N_STEPS, 2) pose gaps: m,
    rad."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    laser = LaserModel.from_array(d["laser"])
    jspec = jfp.FrontendSpec.from_config(J.load_config(SIM_YAML, **OVER),
                                         laser.range_max, 24.0)
    tspec = tfp.FrontendSpec.from_config(T.load_config(SIM_YAML, **OVER),
                                         laser.range_max, 24.0)
    jstate = jfp.init_frontend_state(jspec)
    tstate = state_from_jax({k: np.asarray(v) for k, v in _jax_state_arrays(jstate).items()},
                            "cpu")
    jstep = jax.jit(jfp.frontend_step, static_argnames=("spec",))
    gaps = []
    for i in range(start, start + N_STEPS):
        pts, msk, nv = ranges_to_packed(d["ranges"][i], laser, OVER["max_points"])
        odom = d["odom"][i].astype(np.float32)
        jstate, jinfo = jstep(jspec, jstate, jnp.asarray(pts), jnp.asarray(msk),
                              jnp.int32(nv), jnp.asarray(odom))
        tstate, tinfo = tfp.frontend_step(tspec, tstate, torch.as_tensor(pts),
                                          torch.as_tensor(msk), nv, torch.as_tensor(odom))
        a, b = tinfo.pose.numpy().astype(np.float64), np.asarray(jinfo.pose, np.float64)
        dth = a[2] - b[2]
        gaps.append([np.abs(a[:2] - b[:2]).max(), abs(np.arctan2(np.sin(dth), np.cos(dth)))])
    return np.asarray(gaps)


@pytest.fixture(scope="module")
def replay():
    """Both front ends stepped over the first scans of the icra log; the
    port starts from the JAX package's initial state via state_from_jax."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    laser = LaserModel.from_array(d["laser"])
    jspec = jfp.FrontendSpec.from_config(J.load_config(SIM_YAML, **OVER),
                                         laser.range_max, 24.0)
    tspec = tfp.FrontendSpec.from_config(T.load_config(SIM_YAML, **OVER),
                                         laser.range_max, 24.0)
    jstate = jfp.init_frontend_state(jspec)
    arrays = {k: np.asarray(v) for k, v in _jax_state_arrays(jstate).items()}
    assert set(arrays) == set(STATE_KEYS)
    tstate = state_from_jax(arrays, "cpu")
    jstep = jax.jit(jfp.frontend_step, static_argnames=("spec",))
    steps, scans = [], []
    for i in range(N_STEPS):
        pts, msk, nv = ranges_to_packed(d["ranges"][i], laser, OVER["max_points"])
        odom = d["odom"][i].astype(np.float32)
        # the same step from the JAX state itself (re-seeded every step)
        seeded = state_from_jax(
            {k: np.array(v) for k, v in _jax_state_arrays(jstate).items()}, "cpu")
        _, sinfo = tfp.frontend_step(tspec, seeded, torch.as_tensor(pts),
                                     torch.as_tensor(msk), nv, torch.as_tensor(odom))
        jstate, jinfo = jstep(jspec, jstate, jnp.asarray(pts), jnp.asarray(msk),
                              jnp.int32(nv), jnp.asarray(odom))
        tstate, tinfo = tfp.frontend_step(tspec, tstate, torch.as_tensor(pts),
                                          torch.as_tensor(msk), nv,
                                          torch.as_tensor(odom))
        snap = {k: np.array(v) for k, v in _jax_state_arrays(jstate).items()}
        tsnap = {
            "pub_hits": tstate.pub.hits, "pub_passes": tstate.pub.passes,
            "coarse_probs": tstate.coarse.probs, "fine_probs": tstate.fine.probs,
            "pose": tstate.pose, "last_map_update_pose": tstate.last_map_update_pose,
            "map_penalize_times": tstate.map_penalize_times,
            "scan_index": tstate.scan_index, "last_kept_odom": tstate.last_kept_odom,
        }
        tsnap = {k: v.clone().numpy() for k, v in tsnap.items()}
        steps.append((jinfo, tinfo, snap, tsnap, sinfo))
        scans.append((pts, msk, nv, odom))
    return jspec, tspec, jstate, tstate, steps, scans


def test_state_from_jax_round_trip(replay):
    jspec, tspec, jstate, tstate, steps, _ = replay
    arrays = {k: np.asarray(v) for k, v in _jax_state_arrays(jstate).items()}
    got = state_from_jax(arrays, "cpu")
    np.testing.assert_array_equal(got.fine.probs.numpy(), arrays["fine_probs"])
    np.testing.assert_array_equal(got.pub.passes.numpy(), arrays["pub_passes"])
    assert int(got.scan_index) == int(arrays["scan_index"]) == N_STEPS
    assert got.scan_index.dtype == torch.int32
    with pytest.raises(KeyError):
        state_from_jax({"pose": np.zeros(3)}, "cpu")


def test_frontend_replay_gates_and_counters(replay):
    *_, steps, _ = replay
    for jinfo, tinfo, snap, tsnap, sinfo in steps:
        assert bool(tinfo.map_updated) == bool(jinfo.map_updated)
        assert bool(tinfo.pose_accepted) == bool(jinfo.pose_accepted)
        assert int(tsnap["scan_index"]) == int(snap["scan_index"])
        assert int(tsnap["map_penalize_times"]) == int(snap["map_penalize_times"])
    assert int(steps[-1][3]["scan_index"]) >= N_STEPS - 2     # scans were kept


def test_frontend_replay_pose_score_cov(replay):
    """Each of the 12 steps carried: the port's step from the state JAX's
    jitted ``frontend_step`` reached (``sinfo``, re-seeded every step)
    against JAX's step, at this test's own bars, tighter than the lockstep
    harness's: pose 5e-6, score 1e-5, the positional covariance 2e-3
    relative. The free replay (``tinfo``, each package from its own state)
    is printed, not held: per-step f32 rounding carries through the
    odometry prediction chain and, where it moves a candidate across the
    tie line, jumps (PERF.md §7 item 12)."""
    *_, steps, _ = replay
    free = []
    for jinfo, tinfo, snap, tsnap, sinfo in steps:
        np.testing.assert_allclose(sinfo.pose.numpy(), np.asarray(jinfo.pose), atol=5e-6)
        assert abs(float(sinfo.score) - float(jinfo.score)) <= 1e-5
        # the positional block is a ratio of f32 sums over the top-20 scores
        np.testing.assert_allclose(sinfo.cov.numpy()[:2, :2],
                                   np.asarray(jinfo.cov)[:2, :2], rtol=2e-3, atol=1e-9)
        # the angular variance selects candidates with |x - best| <= one
        # candidate step, and best often lies exactly one step from a
        # candidate: the last f32 bits of the tie-averaged pose decide
        # whether such a candidate counts, and its top-20 window is cut out
        # of a plateau of near-tied scores whose order the last bits decide
        # too. It is a discontinuous function of its input, so it is held to
        # an order of magnitude, not to rounding (the same tier on
        # bit-identical inputs agrees to rounding: test_torch_correlative.py).
        _same_magnitude(sinfo.cov[2, 2], jinfo.cov[2, 2])
        np.testing.assert_array_equal(tsnap["last_kept_odom"], snap["last_kept_odom"])
        # the one fetched summary carries the same values
        np.testing.assert_allclose(tinfo.summary[:3], tinfo.pose.numpy(), atol=0)
        assert tinfo.summary.shape == (tfp.SUMMARY,) == (17,)
        assert (tinfo.summary[12] > 0.5) == bool(tinfo.map_updated)
        free.append(float(np.abs(tinfo.pose.numpy() - np.asarray(jinfo.pose)).max()))
    print({"free_replay_pose_gap_max": max(free), "steps_beyond_3e-5": sum(g > 3e-5 for g in free)})


@pytest.mark.parametrize("name,footprint", [("fine_probs", 25), ("coarse_probs", 49),
                                            ("pub_hits", 1), ("pub_passes", 60)])
def test_frontend_replay_maps_step_by_step(replay, name, footprint):
    *_, steps, _ = replay
    for i, (_, _, snap, tsnap, _) in enumerate(steps):
        differing = int((snap[name] != tsnap[name]).sum())
        # equal cell for cell, except where a pose that differs in its last
        # f32 bits moves ONE beam endpoint across a cell edge: that changes
        # at most one stamp footprint (K*K cells) or one carved ray per
        # step; allow two such events over the replay
        assert differing <= 2 * footprint, (i, name, differing)
    assert (steps[-1][3][name] != steps[0][3][name]).any()     # the maps did change


def test_scan_match_tiers_match_jax(replay):
    """The tiered matcher from one state and one start: JAX's ``scan_match``
    under ``jax.jit`` with its parameters and map specs static, as the JAX
    engine's compiled step runs it, against the port's."""
    jspec, tspec, jstate, tstate, _, scans = replay
    pts, msk, nv, odom = scans[-1]
    init = np.asarray(jstate.pose) + np.array([0.04, -0.03, 0.02], np.float32)
    jmatch = jax.jit(lambda fp, fo, cp, co, p, m, n, pose: jm.scan_match(
        jspec.matcher, jspec.fine_spec, fp, fo, jspec.coarse_spec, cp, co, p, m, n, pose))
    want = jmatch(jstate.fine.probs, jstate.fine.offset, jstate.coarse.probs,
                  jstate.coarse.offset, jnp.asarray(pts), jnp.asarray(msk), jnp.int32(nv),
                  jnp.asarray(init))
    probs = torch.as_tensor(np.array(jstate.fine.probs))
    off = torch.as_tensor(np.array(jstate.fine.offset))
    got = tm.scan_match(tspec.matcher, tspec.fine_spec, probs, off,
                        tspec.coarse_spec, None, None, torch.as_tensor(pts),
                        torch.as_tensor(msk), nv, torch.as_tensor(init))
    # same map, same start: f32 rounding of tie-averaged poses (~1e-6 m)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=5e-6)
    assert abs(float(got.score) - float(want.score)) <= 1e-5
    np.testing.assert_allclose(got.cov.numpy()[:2, :2], np.asarray(want.cov)[:2, :2],
                               rtol=1e-3, atol=1e-9)
    _same_magnitude(got.cov[2, 2], want.cov[2, 2])      # see the replay test
    assert float(got.score) > 0.6


@pytest.mark.parametrize("flag", ["use_optimize_scan_match", "use_fast_correlation_match"])
def test_unported_matchers_raise(flag, replay):
    """These two matchers raised ``NotImplementedError`` while they were not
    ported. Now they are: with either flag set, ``scan_match`` on the
    replay's last state runs and agrees with the JAX package (the name of
    the test is kept from that time)."""
    jspec, tspec, jstate, tstate, _, scans = replay
    over = dict(OVER, **{flag: True})
    if flag == "use_fast_correlation_match":
        # an integer candidate step on the 0.02 m map, and a small beam
        over.update(fast_match_space_resolution=0.02, fast_match_space_size=0.64,
                    fast_match_angle_offset=0.0698, fast_match_angle_resolution=0.0349,
                    fast_match_max_depth=3, fast_match_beam_width=64)
    jparams = jm.MatcherParams.from_config(J.load_config(SIM_YAML, **over))
    tparams = tm.MatcherParams.from_config(T.load_config(SIM_YAML, **over))
    pts, msk, nv, odom = scans[-1]
    init = np.asarray(jstate.pose) + np.array([0.04, -0.03, 0.02], np.float32)
    want = jm.scan_match(jparams, jspec.fine_spec, jstate.fine.probs,
                         jstate.fine.offset, jspec.coarse_spec, jstate.coarse.probs,
                         jstate.coarse.offset, jnp.asarray(pts), jnp.asarray(msk),
                         jnp.int32(nv), jnp.asarray(init))
    t = lambda a: torch.as_tensor(np.array(a))
    got = tm.scan_match(tparams, tspec.fine_spec, t(jstate.fine.probs),
                        t(jstate.fine.offset), tspec.coarse_spec,
                        t(jstate.coarse.probs), t(jstate.coarse.offset),
                        torch.as_tensor(pts), torch.as_tensor(msk), nv,
                        torch.as_tensor(init))
    # the fine and super-fine tiers start from the first stage's pose, which
    # carries the optimizer's f32 rounding (2e-4 m, see
    # test_torch_gauss_newton.py): they snap it back onto their candidate
    # lattices, so the final pose agrees as in test_scan_match_tiers_match_jax
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=2e-5)
    assert abs(float(got.score) - float(want.score)) <= 1e-4
    np.testing.assert_allclose(got.cov.numpy()[:2, :2], np.asarray(want.cov)[:2, :2],
                               rtol=2e-3, atol=1e-9)
    _same_magnitude(got.cov[2, 2], want.cov[2, 2])


def test_chain_match_matches_jax(replay):
    """Two chains of earlier scans matched against the newest scan: the
    port's written-out chain dimension vs the JAX package's vmap."""
    jspec, tspec, jstate, tstate, steps, scans = replay
    laser_range = 8.0
    jb = jbp.BackendSpec.from_config(jspec.config, laser_range, jspec.pub_spec)
    tb = tbp.BackendSpec.from_config(tspec.config, laser_range, tspec.pub_spec)
    n = len(scans)
    all_pts = np.stack([s[0] for s in scans])
    all_msk = np.stack([s[1] for s in scans])
    all_nv = np.array([s[2] for s in scans], np.int32)
    all_poses = np.stack([np.asarray(st[0].pose) for st in steps]).astype(np.float32)
    K = jb.max_chain_scans
    ids = np.full((2, K), -1, np.int64)
    ids[0, :6] = np.arange(0, 6)
    ids[1, :5] = np.arange(3, 8)
    scan_id = n - 1
    center = all_poses[scan_id]
    inits = np.stack([center + [0.03, 0.02, 0.01], center + [-0.02, 0.0, -0.015]]).astype(np.float32)
    pub = (jstate.pub.hits, jstate.pub.passes, jstate.pub.offset)
    want = jbp.chain_match_batch_gather(
        jb, jnp.asarray(all_pts), jnp.asarray(all_msk), jnp.asarray(all_nv),
        jnp.asarray(all_poses), jnp.asarray(ids.astype(np.int32)), jnp.int32(scan_id),
        jnp.asarray(inits), jnp.asarray(center), *pub)
    got = tbp.chain_match_batch_gather(
        tb, torch.as_tensor(all_pts), torch.as_tensor(all_msk),
        torch.as_tensor(all_poses), torch.as_tensor(ids), scan_id,
        int(all_nv[scan_id]), torch.as_tensor(inits), torch.as_tensor(center),
        *[torch.as_tensor(np.array(a)) for a in pub])
    # rebuilt chain maps are max-merges (exact); the match on them rounds as
    # in test_scan_match_tiers_match_jax; the logistic penalty is one exp
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
    np.testing.assert_allclose(got[2].numpy()[:, :2, :2], np.asarray(want[2])[:, :2, :2],
                               rtol=1e-3, atol=1e-9)
    for b in range(2):
        _same_magnitude(got[2][b, 2, 2], want[2][b, 2, 2])  # see the replay test
    assert got[0].shape == (2, 3) and got[2].shape == (2, 3, 3)


# ---- the optimize-first branch, on the box scan of tests/test_matchers.py ----

OPT_CONFIG = dict(
    fine_map_resolution=0.02, coarse_map_resolution=0.08,
    coarse_map_deviation=0.24, fine_map_deviation=0.05,
    gaussian_blur_offset=0.88, use_optimize_scan_match=True,
    optimize_failed_cost=200.0, iterate_times=10,
    cost_decrease_threshold=0.1, cost_min_threshold=0.5,
    coarse_search_space_size=0.6, coarse_search_space_resolution=0.05,
    coarse_search_angle_offset=0.523, coarse_search_angle_resolution=0.0349,
    fine_search_space_size=0.2, fine_search_space_resolution=0.02,
    fine_search_angle_offset=0.175, fine_search_angle_resolution=0.0349,
    super_fine_search_space_size=0.02, super_fine_search_space_resolution=0.01,
    super_fine_search_angle_offset=0.0349,
    super_fine_search_angle_resolution=0.00349,
)


@pytest.fixture(scope="module")
def box_maps():
    """Fine (1024², 0.02 m) and coarse (128², 0.08 m) maps stamped with the
    box scan by the JAX package, as tests/test_matchers.py::_build_maps."""
    import roborts_slam_tpu.models.grid_map as jgm
    import roborts_slam_tpu.ops.raster as jraster
    import roborts_slam_tpu_torch.models.grid_map as tgm

    n, max_points = 160, 192
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3.0 * np.sign(np.cos(th)) * np.abs(np.cos(th)) ** 0.15,
                    2.0 * np.sign(np.sin(th)) * np.abs(np.sin(th)) ** 0.15], -1)
    points = np.zeros((max_points, 2), np.float32)
    points[:n] = pts
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    fkw = dict(resolution=0.02, height=1024, width=1024, deviation=0.05,
               blur_offset=0.88)
    ckw = dict(resolution=0.08, height=128, width=128, deviation=0.24,
               blur_offset=0.88)
    off = np.array([5.12, 5.12], np.float32)
    stamped = {}
    for name, kw in (("fine", fkw), ("coarse", ckw)):
        spec = jgm.ProbMapSpec(**kw)
        m = jraster.stamp_scan(spec, jgm.make_prob_map(spec, offset=off),
                               jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))
        stamped[name] = (spec, tgm.ProbMapSpec(**kw), np.array(m.probs))
    return stamped, off, points, mask, n


@pytest.mark.parametrize("case,over,use_fine", [
    ("succeeds", {}, True),
    # a bar no cost can meet: the optimizer's result is discarded and the
    # coarse correlative tier runs from the initial pose
    ("fails", dict(optimize_failed_cost=1e-3), True),
    # the reference's quirk: without the fine passes the coarse block runs
    # unconditionally, discarding even a successful optimizer result
    ("no_fine_pass", {}, False),
])
def test_scan_match_with_optimizer_matches_jax(box_maps, case, over, use_fine):
    stamped, off, points, mask, n = box_maps
    jf, tf, fine = stamped["fine"]
    jc, tc_, coarse = stamped["coarse"]
    cfg = dict(OPT_CONFIG, **over)
    init = np.array([0.1, -0.05, 0.05], np.float32)
    want = jm.scan_match(jm.MatcherParams.from_config(J.SlamConfig(**cfg)),
                         jf, jnp.asarray(fine), jnp.asarray(off), jc,
                         jnp.asarray(coarse), jnp.asarray(off), jnp.asarray(points),
                         jnp.asarray(mask), jnp.int32(n), jnp.asarray(init),
                         use_fine_scan_match=use_fine)
    tparams = tm.MatcherParams.from_config(T.SlamConfig(**cfg))
    targs = (tf, torch.as_tensor(fine), torch.as_tensor(off), tc_,
             torch.as_tensor(coarse), torch.as_tensor(off), torch.as_tensor(points),
             torch.as_tensor(mask), n)
    got = tm.scan_match(tparams, *targs, torch.as_tensor(init),
                        use_fine_scan_match=use_fine)
    # tier scores: each is a mean of <= 200 map values (1e-5); the optimizer's
    # stage score 1/(1 + cost/failed_cost) carries its cost's 1e-3 relative
    assert abs(float(got.score) - float(want.score)) <= 1e-4
    # pose: tie-averaged lattice candidates, f32 rounding
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=2e-5)
    np.testing.assert_allclose(got.cov.numpy()[:2, :2], np.asarray(want.cov)[:2, :2],
                               rtol=2e-3, atol=1e-9)
    _same_magnitude(got.cov[2, 2], want.cov[2, 2])
    assert np.abs(got.pose.numpy()).max() < 0.04          # test_matchers.py:111
    if case == "succeeds":
        # the first stage really was the optimizer's: its pose differs from
        # what the run with the optimizer's result discarded gives
        assert float(got.score) != pytest.approx(
            float(tm.scan_match(
                tm.MatcherParams.from_config(T.SlamConfig(
                    **dict(cfg, optimize_failed_cost=1e-3))),
                *targs, torch.as_tensor(init)).score), abs=1e-6)


def test_scan_match_batch_selects_per_element(box_maps):
    """Two chains in one call: from the near start the optimizer's cost ends
    below the bar (its pose is taken), from the far start above it (the
    coarse tier's pose is taken). Each element equals its own single call."""
    stamped, off, points, mask, n = box_maps
    _, tf, fine = stamped["fine"]
    _, tc_, coarse = stamped["coarse"]
    tparams = tm.MatcherParams.from_config(T.SlamConfig(**dict(
        OPT_CONFIG, optimize_failed_cost=10.0)))
    inits = np.array([[0.1, -0.05, 0.05], [0.45, 0.4, 0.3]], np.float32)
    pts, msk = torch.as_tensor(points), torch.as_tensor(mask)
    fine_b = torch.as_tensor(np.stack([fine, fine]))
    coarse_b = torch.as_tensor(np.stack([coarse, coarse]))
    o = torch.as_tensor(off)
    batch = tm.scan_match(tparams, tf, fine_b, o, tc_, coarse_b, o, pts, msk, n,
                          torch.as_tensor(inits))
    assert batch.pose.shape == (2, 3) and batch.cov.shape == (2, 3, 3)
    costs = []
    for i in range(2):
        one = tm.scan_match(tparams, tf, fine_b[i], o, tc_, coarse_b[i], o, pts,
                            msk, n, torch.as_tensor(inits[i]))
        np.testing.assert_allclose(batch.pose[i].numpy(), one.pose.numpy(), atol=2e-5)
        assert abs(float(batch.score[i]) - float(one.score)) <= 1e-5
        costs.append(float(tm.optimize_scan_match(
            tc_, tparams.optimize, coarse_b[i], o, pts, msk,
            torch.as_tensor(inits[i])).cost))
    # the two elements took different sides of the select
    assert costs[0] < 10.0 < costs[1], costs
