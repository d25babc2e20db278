"""Port vs JAX package: the windowed (running-range) front-end step, the
running range of the scan store, and the rolling match-map window with its
recenter rebuilds, on the corridor walk of ``tests/test_recenter.py`` (the
scene is built in memory; nothing outside the repository is read)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu.engine as jengine
import roborts_slam_tpu.frontend.processor as jfp
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.engine as tengine
import roborts_slam_tpu_torch.frontend.processor as tfp
from roborts_slam_tpu.io.pgm import GroundTruthMap as JMap
from roborts_slam_tpu.io.simulate import raycast as jraycast
from roborts_slam_tpu.models.scan import LaserModel as JLaser, ranges_to_packed
from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.convert import state_from_jax
from tests import _torch_lockstep as L
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser

torch.set_num_threads(1)

POS_TOL = ANG_TOL = 2e-3       # the engine bar of tests/test_torch_engine.py

# tests/test_e2e_small.py::_small_config, as plain keywords for both packages
SMALL = dict(
    use_odometry=True, use_optimize_scan_match=False,
    use_move_check=True, move_distance_threshold=0.1,
    move_angle_threshold=0.0873, move_time_threshold=3.6,
    map_resolution=0.05, map_min_passthrough=2.0,
    map_update_free_factor=0.0, map_update_occu_factor=0.0,
    map_update_score_threshold=0.5,
    coarse_map_resolution=0.08, coarse_map_deviation=0.24,
    fine_map_resolution=0.02, fine_map_deviation=0.05,
    gaussian_blur_offset=0.88,
    coarse_search_space_size=0.6, coarse_search_space_resolution=0.05,
    coarse_search_angle_offset=0.349, coarse_search_angle_resolution=0.0349,
    coarse_response_threshold=0.6, coarse_use_point_size=100,
    fine_search_space_size=0.2, fine_search_space_resolution=0.02,
    fine_search_angle_offset=0.175, fine_search_angle_resolution=0.0349,
    fine_response_threshold=0.6, fine_use_point_size=100,
    super_fine_search_space_size=0.02,
    super_fine_search_space_resolution=0.01,
    super_fine_search_angle_offset=0.0349,
    super_fine_search_angle_resolution=0.00349,
    super_fine_response_threshold=0.6, super_fine_use_point_size=100,
    use_map_check_feedback=True, map_check_point_num=100,
    map_check_bound_tolerance=2.5, map_check_penalty_gain=0.015,
    loop_match_min_chain_size=8, link_match_min_response=0.68,
    link_scan_max_distance=3.0, loop_match_min_response_coarse=0.7,
    loop_match_max_variance_coarse=0.4, loop_match_min_response_fine=0.7,
    max_points=384, world_size=20.0,
)
LASER = dict(angle_min=-2.0, angle_max=2.0, range_min=0.2, range_max=5.0,
             num_beams=300)


def corridor():
    """Corridor 30 m x 4 m with pillars every 2 m (tests/test_recenter.py),
    and with door recesses 0.4 m deep and 0.6 m wide every 1.5 m in both
    walls: straight walls leave the position along the corridor to a handful
    of pillar beams, so that scores form a plateau along x and two correct
    implementations settle centimetres apart; the recesses pin x."""
    res = 0.05
    H, W = int(6 / res), int(32 / res)
    occ = np.zeros((H, W), bool)
    occ[int(1 / res), :] = True               # y = -2 wall (origin at -3)
    occ[int(5 / res), :] = True               # y = +2 wall
    for x in np.arange(1.0, 31.0, 2.0):
        occ[int(2.2 / res):int(2.5 / res), int(x / res)] = True
    for x0 in np.arange(0.4, 31.0, 1.5):
        a, b = int(x0 / res), int((x0 + 0.6) / res)
        for wall, back in ((int(1 / res), int(0.6 / res)),
                           (int(5 / res), int(5.4 / res))):
            lo, hi = min(wall, back), max(wall, back)
            occ[wall, a + 1:b] = False        # the doorway
            occ[back, a:b + 1] = True         # its back wall
            occ[lo:hi + 1, a] = True          # its two jambs
            occ[lo:hi + 1, b] = True
    return JMap(occupancy=occ, free=~occ, resolution=res,
                origin=np.array([-1.0, -3.0]))


def _traj_diff(a, b):
    d = np.abs(a - b)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    return d


WALK_STEPS = 24
# free runs over walks with odometry noise drawn from these seeds (0: the
# walk's exact odometry); the tests take FREE_VARIANTS
VARIANTS = (0, 1, 2, 3, 4, 5, 6, 7)
FREE_VARIANTS = VARIANTS[:3]
WALK_OVER = dict(SMALL, max_points=384, world_size=70.0, match_map_window=10.0,
                 use_move_check=False)


def walk_feed(seed: int = 0) -> list:
    """The walk's scans (ranges, odometry, stamp): 0.5 m steps along +x,
    ranges cast from the true pose; odometry the true pose, plus for a
    seed other than 0 an error of N(0, 2 cm) in x and y and N(0, 10 mrad)
    in the angle per step, drawn from the seed."""
    gt = corridor()
    rng = np.random.default_rng(seed)
    feed = []
    for step in range(WALK_STEPS):
        pose = np.array([0.5 * step, 0.0, 0.0])
        odom = pose.copy()
        if seed:
            odom += rng.normal(0.0, [0.02, 0.02, 0.01])
        feed.append((jraycast(gt, pose, JLaser(**LASER)), odom, 0.1 * step))
    return feed


def free_run(seed: int) -> tuple:
    """Both engines free over ``walk_feed(seed)``. (JAX's record, the
    port's), the truth the walk's poses."""
    je = J.SlamEngine(J.SlamConfig(**WALK_OVER), JLaser(**LASER),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.SlamConfig(**WALK_OVER), TLaser(**LASER), device="cpu")
    feed = walk_feed(seed)
    for args in feed:
        je.process(*args)
        te.process(*args)
    times = [f[2] for f in feed]
    gt = np.array([[0.5 * k, 0.0, 0.0] for k in range(WALK_STEPS)])
    return parity.run_record(je, times, gt), parity.run_record(te, times, gt)


@pytest.fixture(scope="module")
def walk():
    """The walk +x of test_recenter_rebuilds_from_history through both
    engines, ``match_map_window=10``, cut to 24 steps (0 -> 11.5 m, three
    recenters); the fine/coarse offsets of both are recorded after every
    step. The walk runs into unmapped ground on exact odometry, so nothing
    pulls a pose back once a tie flip has moved it (see the trajectory test):
    past these steps the two engines random-walk apart by millimetres per
    flip, which says nothing about the code under test."""
    gt = corridor()
    over = dict(SMALL, max_points=384, world_size=70.0, match_map_window=10.0,
                use_move_check=False)
    je = J.SlamEngine(J.SlamConfig(**over), JLaser(**LASER),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.SlamConfig(**over), TLaser(**LASER), device="cpu")
    kept = {"j": [], "t": []}
    offs = {"j": [], "t": []}
    for step in range(24):
        pose = np.array([0.5 * step, 0.0, 0.0])
        ranges = jraycast(gt, pose, JLaser(**LASER))
        if je.process(ranges, pose, 0.1 * step):
            kept["j"].append(step)
        if te.process(ranges, pose, 0.1 * step):
            kept["t"].append(step)
        offs["j"].append(np.concatenate([np.asarray(je.state.fine.offset),
                                         np.asarray(je.state.coarse.offset)]))
        offs["t"].append(np.concatenate([te.state.fine.offset.numpy(),
                                         te.state.coarse.offset.numpy()]))
    return je, te, kept, offs


def test_corridor_walk_same_kept_scans_and_recenters(walk):
    je, te, kept, offs = walk
    assert kept["t"] == kept["j"] and len(kept["t"]) >= 22
    oj, ot = np.stack(offs["j"]), np.stack(offs["t"])
    # recenter shifts are whole granules of both lattices: equal to f32
    np.testing.assert_allclose(ot, oj, atol=1e-5)
    steps_t = np.flatnonzero(np.abs(np.diff(ot[:, 0])) > 0)
    steps_j = np.flatnonzero(np.abs(np.diff(oj[:, 0])) > 0)
    np.testing.assert_array_equal(steps_t, steps_j)
    assert len(steps_t) >= 3, steps_t                   # the window moved along
    # the engine's own count of them, and the host time it charged to them
    assert te.diag.recenters == len(steps_t) and te.diag.recenter_time_s > 0
    # the host mirrors of both offsets stayed in step with the device
    np.testing.assert_allclose(te._host_fine_off, ot[-1, :2], atol=1e-5)
    np.testing.assert_allclose(te._host_coarse_off, ot[-1, 2:], atol=1e-5)
    np.testing.assert_allclose(te._host_fine_off, je._host_fine_off, atol=1e-9)
    np.testing.assert_allclose(te._host_coarse_off, je._host_coarse_off, atol=1e-9)


@pytest.mark.parametrize("form", ["lockstep"] + [f"free-{v}" for v in FREE_VARIANTS])
def test_corridor_walk_trajectories_agree(walk, form):
    """``lockstep``: the walk's 24 steps (three recenters) from the JAX
    engine's carried state (its float64 host offsets included) at the
    per-step bars (pose 1e-5 m / 1e-5 rad, score, covariance, decisions,
    map cells where no recenter rebuilt them), at most 3 tie flips.
    ``free-<seed>``: both engines free over the walk with that odometry
    noise (0: ``walk``'s exact odometry), at the bars of a whole run (the
    same closures and solves, kept within one scan, ATE within max(1.25 x
    JAX's, JAX's + 5 mm) against the walk's true poses). A free walk runs
    into unmapped ground, where nothing pulls a pose back once a tie flip
    has moved it: its count of poses beyond 2e-3 m is printed, not held."""
    if form == "lockstep":
        je = J.SlamEngine(J.SlamConfig(**WALK_OVER), JLaser(**LASER),
                          synchronous_backend=True, fused_backend=False)
        feed = [("process", args) for args in walk_feed(0)]
        rep = L.lockstep(je, feed, name="corridor walk")
        L.assert_lockstep(rep)
        assert sum(r["maps_rebuilt"] for r in rep.rows) >= 3          # the recenters
        return
    seed = int(form.split("-")[1])
    if seed == 0:
        je, te, _, _ = walk
        times = [0.1 * k for k in range(WALK_STEPS)]
        gt = np.array([[0.5 * k, 0.0, 0.0] for k in range(WALK_STEPS)])
        jrec, trec = parity.run_record(je, times, gt), parity.run_record(te, times, gt)
    else:
        jrec, trec = free_run(seed)
    assert np.isfinite(trec["poses"]).all()
    L.assert_free(jrec, trec, f"corridor walk {form}")


def test_corridor_walk_match_maps_agree(walk):
    je, te, _, _ = walk
    for name in ("fine", "coarse"):
        jm = np.asarray(getattr(je.state, name).probs)
        tm = getattr(te.state, name).probs.numpy()
        assert jm.shape == tm.shape
        # rebuilt from the same stored scans at poses equal to ~1e-4 m: the
        # maps differ only where an endpoint crosses a cell edge (one blur
        # footprint each)
        assert (jm != tm).mean() <= 0.002, (name, (jm != tm).mean())
        assert (tm > 0.9).any()


def test_rebuild_match_maps_at_brings_back_old_walls(walk):
    """Re-center the port's window back over the start region: content from
    the early scans is rebuilt into it (tests/test_recenter.py:105-120), and
    the JAX engine asked for the same window gives the same map."""
    je, te, _, _ = walk
    fs = te.fspec.fine_spec
    cs = te.fspec.coarse_spec
    extent = fs.width * fs.resolution
    saved = (te.state.fine, te.state.coarse, te._host_fine_off, te._host_coarse_off,
             je.state, je._host_fine_off, je._host_coarse_off)
    home_off = np.array([extent / 2, extent / 2])
    coarse_off = np.asarray([cs.width * cs.resolution / 2] * 2)
    te._rebuild_match_maps_at(home_off, coarse_off)
    with je._state_lock:
        je._rebuild_match_maps_at(home_off, coarse_off)
    probs = te.state.fine.probs.numpy()
    hits = 0
    for wx in np.arange(0.0, 3.0, 0.25):
        mx = int(round((wx + home_off[0]) / fs.resolution))
        my = int(round((2.0 + home_off[1]) / fs.resolution))
        hits += probs[my, mx] > fs.default_prob + 0.2
    assert hits >= 8, f"old corridor walls not rebuilt (hits={hits})"
    np.testing.assert_allclose(te.state.fine.offset.numpy(), home_off, atol=1e-6)
    np.testing.assert_allclose(te._host_coarse_off, coarse_off)
    assert (np.asarray(je.state.fine.probs) != probs).mean() <= 0.002
    # restore for the other tests of this module
    (te.state.fine, te.state.coarse, te._host_fine_off, te._host_coarse_off,
     je.state, je._host_fine_off, je._host_coarse_off) = saved


@pytest.mark.parametrize("fine,coarse", [(0.01, 0.1), (0.025, 0.1), (0.02, 0.08),
                                         (0.02, 0.05), (0.03, 0.1)])
def test_shift_granule(fine, coarse):
    over = dict(SMALL, fine_map_resolution=fine, coarse_map_resolution=coarse,
                match_map_window=8.0)
    je = J.SlamEngine(J.SlamConfig(**over), JLaser(**LASER),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.SlamConfig(**over), TLaser(**LASER), device="cpu")
    g = te._shift_granule()
    assert g == je._shift_granule()
    for r in (fine, coarse):
        assert abs(g / r - round(g / r)) < 1e-9 and round(g / r) >= 1


def test_running_range_ids_match_jax():
    """The sliding window of recent scans: capped by count, then shrunk from
    the front while its position span exceeds the bound."""
    rng = np.random.default_rng(3)
    js = jengine.ScanStore(8, running_range_max_scans=6,
                           running_range_max_distance=2.0)
    ts = tengine.ScanStore(8, "cpu", running_range_max_scans=6,
                           running_range_max_distance=2.0)
    pts = np.zeros((8, 2), np.float32)
    msk = np.ones(8, bool)
    pos = np.zeros(3)
    seen = []
    for i in range(40):
        pos = pos + np.array([*rng.uniform(-0.2, 0.9, 2), 0.1])
        for st in (js, ts):
            st.add(pts, msk, 8, pos, pos, 0.1 * i)
        assert ts.running_ids == js.running_ids
        seen.append(len(ts.running_ids))
    assert max(seen) <= 6 and min(seen[5:]) >= 1 and len(set(seen)) > 1
    wp, wm, wposes, valid = ts.running_range_arrays()
    assert wp.shape == (len(ts.running_ids), 8, 2) and bool(valid.all())
    np.testing.assert_allclose(wposes.numpy(),
                               np.asarray([ts.poses[i] for i in ts.running_ids]),
                               atol=1e-6)


@pytest.fixture(scope="module")
def windowed_state():
    """Both front ends after six plain steps down the corridor, and the six
    scans as the running-range window."""
    gt = corridor()
    over = dict(SMALL, world_size=24.0, use_move_check=False,
                use_running_range_scan_match=True)
    jspec = jfp.FrontendSpec.from_config(J.SlamConfig(**over), 5.0, 24.0)
    tspec = tfp.FrontendSpec.from_config(T.SlamConfig(**over), 5.0, 24.0)
    assert tspec.window_fine_spec == tfp.backend_map_specs(tspec.config, 5.0)[1]
    assert (tspec.window_fine_spec.height, tspec.window_coarse_spec.height) == \
        (jspec.window_fine_spec.height, jspec.window_coarse_spec.height)
    jstate = jfp.init_frontend_state(jspec)
    scans, poses = [], []
    for step in range(7):
        pose = np.array([0.4 * step, 0.0, 0.0])
        pts, msk, nv = ranges_to_packed(jraycast(gt, pose, JLaser(**LASER)),
                                        JLaser(**LASER), 384)
        scans.append((pts, msk, nv, pose.astype(np.float32)))
        if step < 6:
            jstate, info = jfp.frontend_step(
                jspec, jstate, jnp.asarray(pts), jnp.asarray(msk), jnp.int32(nv),
                jnp.asarray(pose, jnp.float32))
            poses.append(np.asarray(info.pose))
    return jspec, tspec, jstate, scans, np.stack(poses)


def _to_torch_state(jstate):
    return state_from_jax({
        "pub_hits": np.array(jstate.pub.hits), "pub_passes": np.array(jstate.pub.passes),
        "pub_offset": np.array(jstate.pub.offset),
        "coarse_probs": np.array(jstate.coarse.probs),
        "coarse_offset": np.array(jstate.coarse.offset),
        "fine_probs": np.array(jstate.fine.probs),
        "fine_offset": np.array(jstate.fine.offset),
        "pose": np.array(jstate.pose),
        "last_map_update_pose": np.array(jstate.last_map_update_pose),
        "map_penalize_times": np.array(jstate.map_penalize_times),
        "scan_index": np.array(jstate.scan_index),
        "last_kept_odom": np.array(jstate.last_kept_odom)}, "cpu")


@pytest.mark.parametrize("n_window", [6, 3])
def test_frontend_step_windowed_matches_jax(windowed_state, n_window):
    jspec, tspec, jstate, scans, poses = windowed_state
    win = scans[6 - n_window:6]
    wp = np.stack([s[0] for s in win])
    wm = np.stack([s[1] for s in win])
    wposes = poses[6 - n_window:].astype(np.float32)
    pts, msk, nv, odom = scans[6]
    # the JAX engine pads the window to running_range_size with invalid slots
    pad = 8 - n_window
    jwp = np.concatenate([wp, np.zeros((pad, *wp.shape[1:]), np.float32)])
    jwm = np.concatenate([wm, np.zeros((pad, wm.shape[1]), bool)])
    jwposes = np.concatenate([wposes, np.zeros((pad, 3), np.float32)])
    jvalid = np.arange(8) < n_window
    jnew, jinfo = jfp.frontend_step_windowed(
        jspec, jstate, jnp.asarray(jwp), jnp.asarray(jwm), jnp.asarray(jwposes),
        jnp.asarray(jvalid), jnp.asarray(pts), jnp.asarray(msk), jnp.int32(nv),
        jnp.asarray(odom))
    tstate = _to_torch_state(jstate)
    tnew, tinfo = tfp.frontend_step_windowed(
        tspec, tstate, torch.as_tensor(wp), torch.as_tensor(wm),
        torch.as_tensor(wposes), torch.ones(n_window, dtype=torch.bool),
        torch.as_tensor(pts), torch.as_tensor(msk), nv, torch.as_tensor(odom))
    # one step from the same state: the bars of the front-end replay test
    np.testing.assert_allclose(tinfo.pose.numpy(), np.asarray(jinfo.pose), atol=5e-6)
    assert abs(float(tinfo.score) - float(jinfo.score)) <= 1e-5
    np.testing.assert_allclose(tinfo.cov.numpy()[:2, :2], np.asarray(jinfo.cov)[:2, :2],
                               rtol=2e-3, atol=1e-9)
    assert bool(tinfo.map_updated) == bool(jinfo.map_updated) is True
    assert float(tinfo.score) > 0.6
    # the persistent maps were updated as in the plain step
    assert (tnew.fine.probs.numpy() != np.asarray(jnew.fine.probs)).sum() <= 25
    assert int(tnew.scan_index) == int(jnew.scan_index) == 7


def test_windowed_engine_matches_jax():
    """``use_running_range_scan_match`` through both engines: the window is
    gathered from the store's device mirror by id."""
    gt = corridor()
    over = dict(SMALL, world_size=30.0, use_move_check=False,
                use_running_range_scan_match=True, running_range_size=8,
                running_range_max_distance=2.0)
    je = J.SlamEngine(J.SlamConfig(**over), JLaser(**LASER),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.SlamConfig(**over), TLaser(**LASER), device="cpu")
    kj, kt = [], []
    for step in range(14):
        pose = np.array([0.4 * step, 0.0, 0.0])
        ranges = jraycast(gt, pose, JLaser(**LASER))
        kj.append(je.process(ranges, pose, 0.1 * step))
        kt.append(te.process(ranges, pose, 0.1 * step))
    assert kt == kj and sum(kt) >= 12
    assert te.store.running_ids == je.store.running_ids
    assert len(te.store.running_ids) < 8 <= len(te.store)   # the span bound cut it
    d = _traj_diff(je.trajectory_array(), te.trajectory_array())
    assert d[:, 1:3].max() <= POS_TOL and d[:, 3].max() <= ANG_TOL, d.max(0)
