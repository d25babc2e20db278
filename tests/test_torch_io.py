"""Port vs JAX package: the host-side ``io/`` modules (de-distortion, scan
log, simulator, PGM loading), ``utils/evaluation.py`` and the engine's
de-distortion on ingest. These modules are NumPy on both sides, so the same
seed gives equal arrays (held to 1e-6); scenes are built in memory."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu.io.dedistort as jdd
import roborts_slam_tpu.io.pgm as jpgm
import roborts_slam_tpu.io.scan_log as jlog
import roborts_slam_tpu.io.scenes as jscenes
import roborts_slam_tpu.io.simulate as jsim
import roborts_slam_tpu.utils.evaluation as jev
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.io.dedistort as tdd
import roborts_slam_tpu_torch.io.pgm as tpgm
import roborts_slam_tpu_torch.io.scan_log as tlog
import roborts_slam_tpu_torch.io.scenes as tscenes
import roborts_slam_tpu_torch.io.simulate as tsim
import roborts_slam_tpu_torch.utils.evaluation as tev
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser

torch.set_num_threads(1)

LASER = dict(angle_min=-2.2, angle_max=2.2, range_min=0.1, range_max=6.0,
             num_beams=120)


def room(cls):
    """An 8 m x 6 m room at 0.05 m with an inner block and two pillars."""
    res = 0.05
    H, W = int(6 / res), int(8 / res)
    occ = np.zeros((H, W), bool)
    occ[0, :] = occ[-1, :] = True
    occ[:, 0] = occ[:, -1] = True
    occ[int(2.5 / res):int(3.5 / res), int(3.2 / res):int(4.8 / res)] = True
    occ[int(1.0 / res):int(1.3 / res), int(1.5 / res):int(1.8 / res)] = True
    occ[int(4.6 / res):int(4.9 / res), int(6.0 / res):int(6.3 / res)] = True
    return cls(occupancy=occ, free=~occ, resolution=res,
               origin=np.array([-4.0, -3.0]))


def test_dedistort_matches_jax():
    rng = np.random.default_rng(1)
    jl, tl = JLaser(**LASER), TLaser(**LASER)
    ranges = rng.uniform(0.0, 7.0, 120).astype(np.float32)
    ot = np.linspace(-0.02, 0.12, 9)
    op = np.stack([0.3 * ot, -0.1 * ot, 3.0 + 2.5 * ot], -1)   # yaw crosses pi
    op[:, 2] = np.arctan2(np.sin(op[:, 2]), np.cos(op[:, 2]))
    for ref in ("start", "end"):
        want = jdd.dedistort_scan(ranges, jl, 0.0, 0.1, ot, op, reference=ref)
        got = tdd.dedistort_scan(ranges, tl, 0.0, 0.1, ot, op, reference=ref)
        np.testing.assert_allclose(got, want, atol=1e-6, equal_nan=True)
        assert np.isnan(got[ranges >= 6.0]).all() and np.isfinite(got).any()
    t = np.linspace(0.0, 0.1, 7)
    np.testing.assert_allclose(tdd.interpolate_poses(t, ot, op),
                               jdd.interpolate_poses(t, ot, op), atol=1e-12)
    # tests/test_dedistort.py::test_interpolate_poses_linear
    p = tdd.interpolate_poses(np.array([0.25, 0.5]), np.array([0.0, 1.0]),
                              np.array([[0.0, 0.0, 0.0], [2.0, -1.0, 1.0]]))
    np.testing.assert_allclose(p, [[0.5, -0.25, 0.25], [1.0, -0.5, 0.5]])


def test_raycast_matches_jax():
    jg, tg = room(jpgm.GroundTruthMap), room(tpgm.GroundTruthMap)
    for pose in ([0.0, -1.5, 0.3], [-3.0, 2.0, -2.0], [3.5, -2.5, 1.0]):
        pose = np.array(pose)
        want = jsim.raycast(jg, pose, JLaser(**LASER), np.random.default_rng(2), 0.01)
        got = tsim.raycast(tg, pose, TLaser(**LASER), np.random.default_rng(2), 0.01)
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert got.dtype == np.float32 and (got < 6.0).any()


@pytest.fixture(scope="module")
def logs():
    """One simulated loop of the room from each package: waypoints, A* path,
    trajectory, noisy odometry and ray-cast ranges, all from one seed."""
    kw = dict(speed=0.8, scan_rate=5.0, odom_error=(0.03, 0.03, 0.05),
              range_noise=0.01, n_waypoints=4, seed=11, clearance_m=0.3)
    want = jsim.simulate_log(room(jpgm.GroundTruthMap), JLaser(**LASER), **kw)
    got = tsim.simulate_log(room(tpgm.GroundTruthMap), TLaser(**LASER), **kw)
    return got, want


def test_simulate_log_matches_jax(logs):
    got, want = logs
    assert len(got) == len(want) > 20
    for name in ("ranges", "odom", "times", "gt_poses"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-6, err_msg=name)
    assert got.laser == TLaser(**LASER)
    # the robot went round the block
    assert np.ptp(got.gt_poses[:, 0]) > 2.0 and np.ptp(got.gt_poses[:, 1]) > 1.0


def test_scan_log_round_trip_across_packages(logs, tmp_path):
    got, want = logs
    a, b = str(tmp_path / "from_port.npz"), str(tmp_path / "from_jax.npz")
    got.save(a)
    want.save(b)
    for loader, laser_cls in ((tlog.ScanLog.load, TLaser), (jlog.ScanLog.load, JLaser)):
        for path in (a, b):
            back = loader(path)
            assert isinstance(back.laser, laser_cls)
            assert dataclasses.asdict(back.laser) == dataclasses.asdict(got.laser)
            np.testing.assert_array_equal(back.ranges, got.ranges.astype(np.float32))
            np.testing.assert_array_equal(back.odom, got.odom)
            np.testing.assert_array_equal(back.gt_poses, got.gt_poses)
    # a log without ground truth loads with gt_poses None
    bare = tlog.ScanLog(got.ranges, got.odom, got.times, got.laser)
    bare.save(a)
    assert tlog.ScanLog.load(a).gt_poses is None
    assert jlog.ScanLog.load(a).gt_poses is None


def test_evaluation_matches_jax(logs):
    got, _ = logs
    rng = np.random.default_rng(4)
    keep = np.sort(rng.choice(len(got), 15, replace=False))
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = np.concatenate([
        got.times[keep, None],
        got.gt_poses[keep, :2] @ R.T + [1.0, -2.0] + rng.normal(0, 0.02, (15, 2)),
        got.gt_poses[keep, 2:3]], 1)
    te, tg = tev.match_by_time(est, got.gt_poses, got.times)
    je, jg = jev.match_by_time(est, got.gt_poses, got.times)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tg, jg)
    for align in (True, False):
        assert tev.ate_rmse(te, tg, align) == pytest.approx(jev.ate_rmse(je, jg, align),
                                                            abs=1e-12)
    assert tev.ate_rmse(te, tg) < 0.05 < tev.ate_rmse(te, tg, align=False)


def test_pgm_and_scenes(tmp_path):
    """A map_server YAML + PGM pair written here loads equally in both
    packages; the scene presets are the same; the scene maps themselves are
    not part of the repository."""
    img = np.full((30, 40), 254, np.uint8)
    img[0, :] = img[:, 0] = 0
    img[10:14, 20:25] = 0
    img[20:, 30:] = 205
    with open(tmp_path / "m.pgm", "wb") as f:
        f.write(b"P5\n# a comment\n40 30\n255\n" + img.tobytes())
    (tmp_path / "m.yaml").write_text(
        "image: m.pgm\nresolution: 0.05\norigin: [-1.0, -0.75, 0.0]\n"
        "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    want = jpgm.load_ground_truth_map(str(tmp_path / "m.yaml"))
    got = tpgm.load_ground_truth_map(str(tmp_path / "m.yaml"))
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    np.testing.assert_array_equal(got.free, want.free)
    assert got.resolution == want.resolution and (got.origin == want.origin).all()
    assert got.occupancy[-1].all() and not got.free[:10, 30:].any()
    assert (got.width, got.height) == (40, 30)
    assert set(tscenes.SCENES) == set(jscenes.SCENES)
    for name, sc in tscenes.SCENES.items():
        other = jscenes.SCENES[name]
        assert dataclasses.asdict(sc.laser) == dataclasses.asdict(other.laser)
        # the same files, looked for in the port's own maps directory
        assert os.path.dirname(sc.map_yaml) == tscenes.REFERENCE_MAPS_DIR
        assert (os.path.basename(sc.map_yaml), sc.odom_error, sc.n_waypoints) == \
            (os.path.basename(other.map_yaml), other.odom_error, other.n_waypoints)
    if not os.path.exists(tscenes.SCENES["icra"].map_yaml):
        with pytest.raises(FileNotFoundError):
            tscenes.load_scene_map(tscenes.SCENES["icra"])


def test_engine_dedistorts_a_rotating_sweep_like_jax():
    """``use_odom_correct`` with ``scan_time > 0``: a robot turning in the
    room while it sweeps. Both engines de-distort every scan after the first
    on ingest (NumPy on both sides: the stored points are equal) and keep
    the same scans on trajectories within the engine bar."""
    gt = room(jpgm.GroundTruthMap)
    over = dict(
        use_odom_correct=True, use_optimize_scan_match=False,
        fine_map_resolution=0.02, coarse_map_resolution=0.08,
        coarse_map_deviation=0.24, fine_map_deviation=0.05,
        map_update_score_threshold=0.5, max_points=128, world_size=16.0)
    jl = JLaser(**LASER, scan_time=0.05)
    tl = TLaser(**LASER, scan_time=0.05)
    je = J.SlamEngine(J.SlamConfig(**over), jl, synchronous_backend=True,
                      fused_backend=False)
    te = T.SlamEngine(T.SlamConfig(**over), tl, device="cpu")
    calls = []
    inner = te._dedistorted_points
    te._dedistorted_points = lambda r, t: calls.append(t) or inner(r, t)
    kj, kt = [], []
    for k in range(12):
        pose = np.array([0.05 * k, -1.5 + 0.02 * k, 0.12 * k])
        ranges = jsim.raycast(gt, pose, jl)
        kj.append(je.process(ranges, pose, 0.1 * k))
        kt.append(te.process(ranges, pose, 0.1 * k))
    assert kt == kj and sum(kt) >= 10
    assert len(calls) == 11                      # every scan after the first
    assert te.diag.scans_dedistorted == 11 and te.diag.dedistort_time_s > 0
    np.testing.assert_allclose(np.stack(te.store._points), np.stack(je.store._points),
                               atol=1e-6)
    assert te.store._n_valid == je.store._n_valid
    # the correction did move points: the second stored scan differs from
    # its plain polar conversion
    from roborts_slam_tpu_torch.models.scan import ranges_to_packed
    plain = ranges_to_packed(jsim.raycast(gt, np.array([0.05, -1.48, 0.12]), jl), tl, 128)[0]
    assert np.abs(plain - te.store._points[1]).max() > 1e-3
    a, b = je.trajectory_array(), te.trajectory_array()
    d = np.abs(a - b)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    assert d[:, 1:3].max() <= 2e-3 and d[:, 3].max() <= 2e-3, d.max(0)
