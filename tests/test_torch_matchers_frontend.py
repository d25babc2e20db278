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
    *_, steps, _ = replay
    for jinfo, tinfo, snap, tsnap, sinfo in steps:
        # a free-running replay: per-step f32 rounding (~1e-6 m, from
        # tie-averaged poses in cells) accumulates through the odometry
        # prediction chain over the 12 steps
        np.testing.assert_allclose(tinfo.pose.numpy(), np.asarray(jinfo.pose), atol=3e-5)
        np.testing.assert_allclose(tsnap["last_map_update_pose"],
                                   snap["last_map_update_pose"], atol=3e-5, rtol=1e-6)
        # the score is a mean of three tier responses times the penalty
        assert abs(float(tinfo.score) - float(jinfo.score)) <= 1e-4
        # the positional block is a ratio of f32 sums over the top-20 scores
        np.testing.assert_allclose(tinfo.cov.numpy()[:2, :2],
                                   np.asarray(jinfo.cov)[:2, :2], rtol=2e-3, atol=1e-9)
        # the angular variance selects candidates with |x - best| <= one
        # candidate step, and best often lies exactly one step from a
        # candidate: the last f32 bits of the tie-averaged pose decide
        # whether such a candidate counts, and its top-20 window is cut out
        # of a plateau of near-tied scores whose order the last bits decide
        # too. It is a discontinuous function of its input, so it is held to
        # an order of magnitude, not to rounding (the same tier on
        # bit-identical inputs agrees to rounding: test_torch_correlative.py).
        for info in (tinfo, sinfo):
            _same_magnitude(info.cov[2, 2], jinfo.cov[2, 2])
        np.testing.assert_allclose(sinfo.cov.numpy()[:2, :2],
                                   np.asarray(jinfo.cov)[:2, :2], rtol=2e-3, atol=1e-9)
        np.testing.assert_allclose(sinfo.pose.numpy(), np.asarray(jinfo.pose), atol=5e-6)
        assert abs(float(sinfo.score) - float(jinfo.score)) <= 1e-5
        np.testing.assert_array_equal(tsnap["last_kept_odom"], snap["last_kept_odom"])
        # the one fetched summary carries the same values
        np.testing.assert_allclose(tinfo.summary[:3], tinfo.pose.numpy(), atol=0)
        assert tinfo.summary.shape == (15,)
        assert (tinfo.summary[12] > 0.5) == bool(tinfo.map_updated)


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
    jspec, tspec, jstate, tstate, _, scans = replay
    pts, msk, nv, odom = scans[-1]
    init = np.asarray(jstate.pose) + np.array([0.04, -0.03, 0.02], np.float32)
    want = jm.scan_match(jspec.matcher, jspec.fine_spec, jstate.fine.probs,
                         jstate.fine.offset, jspec.coarse_spec, jstate.coarse.probs,
                         jstate.coarse.offset, jnp.asarray(pts), jnp.asarray(msk),
                         jnp.int32(nv), jnp.asarray(init))
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
def test_unported_matchers_raise(flag):
    params = tm.MatcherParams.from_config(T.load_config(SIM_YAML, **{flag: True}))
    with pytest.raises(NotImplementedError):
        tm.scan_match(params, None, torch.zeros(4, 4), None, None, None, None,
                      None, None, 0, None)


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
