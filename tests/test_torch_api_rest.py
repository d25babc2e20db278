"""Port vs JAX package: the rest of the public API — the log-odds map and
its update, ``endpoint_image``, the dense SPA solve, ``Scan`` /
``scan_from_ranges`` / ``barycenter_pose``, the ``ScanLog`` export and the
converters of ``convert.py`` — on the same NumPy inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.backend.spa as jspa
import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.models.scan as jscan
import roborts_slam_tpu.ops.raster as jr
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.backend.spa as tspa
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.models.scan as tscan
import roborts_slam_tpu_torch.ops.raster as tr
from roborts_slam_tpu_torch.convert import log_odds_map_from_jax, pose_graph_from_jax
from tests.test_torch_spa import _both, _make_loop_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def willow():
    d = np.load(os.path.join(REPO, "tests", "data", "golden_willow.npz"))
    return (jscan.LaserModel.from_array(d["laser"]), tscan.LaserModel.from_array(d["laser"]),
            d["ranges"], d["odom"], d["times"])


# ---- the log-odds map ----

@pytest.mark.parametrize("p", [0.1, 0.3, 0.5, 0.9])
def test_log_odds_conversions_equal(p):
    """tests/test_aux_subsystems.py:15-18: round trip within 1e-6, and each
    conversion within 1e-6 of the JAX one (one f32 log / exp each)."""
    lo = tgm.prob_to_log_odds(torch.tensor(p, dtype=torch.float32))
    want = jgm.prob_to_log_odds(jnp.float32(p))
    assert abs(float(lo) - float(want)) <= 1e-6
    assert abs(float(tgm.log_odds_to_prob(lo)) - p) <= 1e-6
    assert abs(float(tgm.log_odds_to_prob(lo)) - float(jgm.log_odds_to_prob(want))) <= 1e-6


def _beams(P=16):
    pts = np.zeros((P, 2), np.float32)
    pts[:8, 0] = 3.0                      # 8 beams straight +x, 3 m
    pts[8:12] = [[0.5, 2.0], [-2.5, 1.0], [-1.0, -3.5], [2.0, -2.0]]
    msk = np.zeros(P, bool)
    msk[:12] = True
    return pts, msk


def test_log_odds_map_update_equals_jax():
    """tests/test_aux_subsystems.py:21-43 on both packages, three scans from
    three poses: the same log-odds bit for bit (the same mark image, the
    same f32 increments in the same order) and the same states."""
    jspec = jgm.CountMapSpec(resolution=0.1, height=128, width=128, max_ray_cells=64)
    tspec = tgm.CountMapSpec(resolution=0.1, height=128, width=128, max_ray_cells=64)
    jl = jgm.make_log_odds_map(jspec, offset=[6.4, 6.4])
    tl = tgm.make_log_odds_map(tspec, [6.4, 6.4], "cpu")
    pts, msk = _beams()
    poses = np.array([[0, 0, 0], [0.3, -0.2, 0.1], [-0.4, 0.5, -0.3]], np.float32)
    for pose in poses:
        jl = jr.update_log_odds_map(jspec, jl, jnp.asarray(pts), jnp.asarray(msk),
                                    jnp.asarray(pose))
        tl = tr.update_log_odds_map(tspec, tl, torch.as_tensor(pts), torch.as_tensor(msk),
                                    torch.as_tensor(pose))
    np.testing.assert_array_equal(tl.log_odds.numpy(), np.asarray(jl.log_odds))
    states = tgm.log_odds_map_states(tl).numpy()
    np.testing.assert_array_equal(states, np.asarray(jgm.log_odds_map_states(jl)))
    ex, ey = int((3.0 + 6.4) / 0.1), int(6.4 / 0.1)
    assert states[ey, ex] == 100 and states[5, 5] == -1
    assert states[ey, int((1.5 + 6.4) / 0.1)] == 0
    # a JAX map carried over and updated once more on both sides
    back = log_odds_map_from_jax({"log_odds": np.asarray(jl.log_odds),
                                  "offset": np.asarray(jl.offset)}, "cpu")
    jl = jr.update_log_odds_map(jspec, jl, jnp.asarray(pts), jnp.asarray(msk),
                                jnp.asarray(poses[1]))
    back = tr.update_log_odds_map(tspec, back, torch.as_tensor(pts), torch.as_tensor(msk),
                                  torch.as_tensor(poses[1]))
    np.testing.assert_array_equal(back.log_odds.numpy(), np.asarray(jl.log_odds))
    np.testing.assert_array_equal(back.offset.numpy(), np.asarray(jl.offset))


# ---- endpoint_image ----

@pytest.mark.parametrize("scan,pose", [(0, (0.0, 0.0, 0.0)), (20, (1.3, -0.7, 0.9)),
                                       (45, (-4.0, 3.5, -2.2))])
def test_endpoint_image_equals_jax(willow, scan, pose):
    """Willow scans into a 0.05 m 256² map (beams off the map dropped, the
    far pose off to one side): identical images."""
    jlaser, tlaser, ranges, _, _ = willow
    pts, msk, _ = jscan.ranges_to_packed(ranges[scan], jlaser, 1152)
    jspec = jgm.ProbMapSpec(0.05, 256, 256, 0.05, 0.88)
    tspec = tgm.ProbMapSpec(0.05, 256, 256, 0.05, 0.88)
    off = np.array([6.4, 6.4], np.float32)
    pose = np.asarray(pose, np.float32)
    want = np.asarray(jr.endpoint_image(jspec, jnp.asarray(off), jnp.asarray(pts),
                                        jnp.asarray(msk), jnp.asarray(pose)))
    got = tr.endpoint_image(tspec, torch.as_tensor(off), torch.as_tensor(pts),
                            torch.as_tensor(msk), torch.as_tensor(pose)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 10


# ---- the dense SPA solve ----

@pytest.mark.parametrize("noise,seed", [(0.05, 3), (0.08, 7), (0.05, 0)])
def test_dense_solve_equals_jax(noise, seed):
    """Both packages' dense LM on the same graph: cost within 1e-5 relative,
    poses within 1e-4 (the same f32 LU solves; the sums into H are taken in
    another order), the same stopping rule."""
    arrays, gt, n = _make_loop_graph(noise=noise, seed=seed)
    jd, td = _both(arrays)
    jp, jc = jspa.solve_pose_graph_dense(jd)
    before = tspa.host_syncs
    tp, tc = tspa.solve_pose_graph_dense(td)
    assert tspa.host_syncs > before
    assert abs(float(tc) - float(jc)) <= 1e-5 * float(jc) + 1e-7
    # padding nodes included: pinned, they move only by the angle wrap
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)


def test_dense_and_pcg_agree():
    """tests/test_spa.py:85-91 on the port: the dense and PCG solves agree
    within 5 % in cost and 0.05 m in position."""
    arrays, gt, n = _make_loop_graph(noise=0.05, seed=3)
    td = _both(arrays)[1]
    p1, c1, _ = tspa.solve_pose_graph(td)
    p2, c2 = tspa.solve_pose_graph_dense(td)
    assert abs(float(c1) - float(c2)) / (float(c2) + 1e-9) < 0.05
    d = np.linalg.norm(p1.numpy()[:n, :2] - p2.numpy()[:n, :2], axis=1)
    assert d.max() < 0.05, d.max()


def test_pose_graph_from_jax():
    arrays = _make_loop_graph(noise=0.05, seed=3)[0]
    jd = _both(arrays)[0]
    got = pose_graph_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, "cpu")
    assert got.edge_ij.dtype == torch.int64 and got.node_mask.dtype == torch.bool
    for name in tspa.PoseGraphData._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    with pytest.raises(KeyError, match="edge_mask"):
        pose_graph_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()
                             if k != "edge_mask"}, "cpu")


# ---- Scan, scan_from_ranges, barycenter_pose ----

@pytest.mark.parametrize("scan", [0, 33, 69])
def test_scan_from_ranges_and_barycenter_equal(willow, scan):
    """Willow scans packed to 1152 points: the same fields bit for bit, and
    barycenters within 1e-5 m (f32 sums over ~1000 points in another
    order)."""
    jlaser, tlaser, ranges, odom, times = willow
    pose = odom[scan] + np.array([0.1, -0.2, 0.05])
    want = jscan.scan_from_ranges(ranges[scan], jlaser, odom[scan], float(times[scan]), 1152,
                                  pose=pose)
    got = tscan.scan_from_ranges(ranges[scan], tlaser, odom[scan], float(times[scan]), 1152,
                                 pose=pose, device="cpu")
    assert isinstance(got, tscan.Scan) and got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.num_valid) == int(want.num_valid)
    odom_only = tscan.scan_from_ranges(ranges[scan], tlaser, odom[scan], 0.0, 1152, device="cpu")
    np.testing.assert_array_equal(odom_only.pose.numpy(), odom[scan].astype(np.float32))
    jb = np.asarray(jscan.barycenter_pose(want.points, want.mask, want.pose))
    tb = tscan.barycenter_pose(got.points, got.mask, got.pose).numpy()
    np.testing.assert_allclose(tb, jb, atol=1e-5)
    assert tb[2] == np.float32(pose[2])


def test_barycenter_of_a_batch_is_per_scan(willow):
    """With a leading batch dim each scan gets its own centroid: row b equals
    the single-scan call on scan b (JAX's divisor would count the batch's
    points, so rows are compared with the port's own single calls); an
    empty scan gives the sensor position."""
    _, tlaser, ranges, odom, _ = willow
    scans = [tscan.scan_from_ranges(ranges[i], tlaser, odom[i], 0.0, 1152, device="cpu")
             for i in (3, 40)]
    pts = torch.stack([s.points for s in scans])
    msk = torch.stack([s.mask for s in scans])
    poses = torch.stack([s.pose for s in scans])
    batch = tscan.barycenter_pose(pts, msk, poses)
    for b, s in enumerate(scans):
        assert torch.equal(batch[b], tscan.barycenter_pose(s.points, s.mask, s.pose))
    empty = tscan.barycenter_pose(pts[0], torch.zeros_like(msk[0]), poses[0])
    assert torch.equal(empty, torch.stack([torch.tensor(0.0), torch.tensor(0.0), poses[0][2]]))


def test_scan_from_ranges_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    laser = tscan.LaserModel(-1.0, 1.0, 0.1, 5.0, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscan.scan_from_ranges(np.full(8, 2.0), laser, np.zeros(3), 0.0, 8)


def test_scan_log_from_the_package_root():
    """The lazy export the JAX package has (``__init__.py:19-22``)."""
    from roborts_slam_tpu_torch.io.scan_log import ScanLog

    assert T.ScanLog is ScanLog and "ScanLog" in T.__all__
    with pytest.raises(AttributeError):
        T.NoSuchThing
