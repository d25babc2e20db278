"""Port vs JAX package: checkpoint and resume (``io/checkpoint.py``). A run
saved midway and resumed continues as the straight-through run does; a
checkpoint written by the JAX package loads in the port, which continues
as the JAX engine does; the port writes the JAX package's key layout, so
the JAX package reads the port's files too. Inputs:
``tests/data/golden_icra.npz`` under ``configs/simulation.yaml`` at the
narrow size of ``test_torch_engine.py``, 40 scans out and the same 40 back
with the link radius cut to 1 m (chain matches and a loop closure)."""

import os

import numpy as np
import pytest
import torch
import yaml

import roborts_slam_tpu as J
import roborts_slam_tpu_torch as T
from roborts_slam_tpu.io.checkpoint import load_checkpoint as jload
from roborts_slam_tpu.io.checkpoint import save_checkpoint as jsave
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from roborts_slam_tpu_torch.io.pgm import GroundTruthMap
from roborts_slam_tpu_torch.io.simulate import simulate_log
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0, link_scan_max_distance=1.0)
ORDER = list(range(40)) + list(range(39, -1, -1))
TIMES = [0.1 * k for k in range(len(ORDER))]
CUT = 50                      # scans fed before the save: inside the way back
POS_TOL = ANG_TOL = 2e-3      # the engine bar of test_torch_engine.py
# the port's float64 host mirrors of the map offsets, beside the JAX layout
HOST_KEYS = {"host_pub_offset", "host_coarse_offset", "host_fine_offset"}


@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _port(icra, sync=True):
    return T.SlamEngine(T.load_config(SIM_YAML, **OVER), TLaser.from_array(icra["laser"]),
                        device="cpu", synchronous_backend=sync)


def _jax(icra):
    return J.SlamEngine(J.load_config(SIM_YAML, **OVER), JLaser.from_array(icra["laser"]),
                        synchronous_backend=True, fused_backend=False)


def _feed(eng, icra, ks):
    for k in ks:
        i = ORDER[k]
        eng.process(icra["ranges"][i], icra["odom"][i], TIMES[k])


def _ang(a):
    return np.abs(np.arctan2(np.sin(a), np.cos(a)))


@pytest.fixture(scope="module")
def straight(icra):
    eng = _port(icra)
    _feed(eng, icra, range(len(ORDER)))
    eng.finish()
    assert eng.backend.num_loop_closures >= 1
    return eng


def _same_state(a, b):
    """Two engines hold the same state, exactly."""
    n = len(a.store)
    assert n == len(b.store) and a.backend.graph.num_vertices == b.backend.graph.num_vertices
    np.testing.assert_array_equal(a.store.poses_array(), b.store.poses_array())
    np.testing.assert_array_equal(np.stack(a.store._points), np.stack(b.store._points))
    assert a.store.running_ids == b.store.running_ids
    assert [(e.source, e.target) for e in a.backend.graph.edges] == \
        [(e.source, e.target) for e in b.backend.graph.edges]
    for x, y in ((a.state.pub.hits, b.state.pub.hits), (a.state.fine.probs, b.state.fine.probs),
                 (a.state.coarse.probs, b.state.coarse.probs), (a.state.pose, b.state.pose),
                 (a.state.scan_index, b.state.scan_index),
                 (a.state.last_kept_odom, b.state.last_kept_odom)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(a.trajectory_array(), b.trajectory_array())
    np.testing.assert_allclose(a._map_to_odom, b._map_to_odom, atol=1e-12)
    assert a.fspec.pub_spec == b.fspec.pub_spec


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_equals_straight_through(icra, straight, tmp_path, mode):
    """Save after 50 of 80 scans (the asynchronous engine is flushed by the
    save), load into a fresh engine, feed the other 30: the trajectory is
    the straight-through run's within 1e-5 (the front end continues from the
    same state; the worker's batches are drained before the save)."""
    sync = mode == "sync"
    part = _port(icra, sync=sync)
    _feed(part, icra, range(CUT))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(part, path)
    assert part._backend_thread is None
    resumed = load_checkpoint(path, synchronous_backend=sync, device="cpu")
    assert resumed.synchronous_backend == sync and resumed.device == torch.device("cpu")
    _same_state(resumed, part)
    np.testing.assert_array_equal(resumed.pose_at(TIMES[CUT - 1]), part.pose_at(TIMES[CUT - 1]))
    assert (resumed.diag.scans_in, resumed.diag.scans_processed) == (CUT, len(part.store))
    if sync:
        _feed(resumed, icra, range(CUT, len(ORDER)))
    else:   # drained after every scan: the blocking engine's order of work
        for k in range(CUT, len(ORDER)):
            _feed(resumed, icra, [k])
            resumed.finish()
    resumed.finish()
    want = straight.trajectory_array()
    got = resumed.trajectory_array()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert resumed.backend.num_links == straight.backend.num_links


def test_jax_checkpoint_loads_in_the_port(icra, tmp_path):
    """A checkpoint the JAX engine wrote (its ``save_checkpoint`` needs the
    ``_dev_time_origin`` attribute that its engine never sets: the test sets
    it) loads in the port with the JAX state as it was, and the port then
    continues as the JAX engine continues, within the engine bar."""
    je = _jax(icra)
    _feed(je, icra, range(CUT))
    je._dev_time_origin = None
    path = str(tmp_path / "jax.npz")
    jsave(je, path)
    te = load_checkpoint(path, device="cpu")
    n = len(je.store)
    assert len(te.store) == n and te.backend.graph.num_vertices == je.backend.graph.num_vertices
    np.testing.assert_array_equal(te.store.poses_array(), je.store.poses_array())
    np.testing.assert_array_equal(te.state.pub.hits.numpy(), np.asarray(je.state.pub.hits))
    np.testing.assert_array_equal(te.state.fine.probs.numpy(), np.asarray(je.state.fine.probs))
    np.testing.assert_array_equal(te.trajectory_array(), je.trajectory_array())
    assert te.backend.num_links == je.backend.num_links
    assert [(e.source, e.target) for e in te.backend.graph.edges] == \
        [(e.source, e.target) for e in je.backend.graph.edges]
    # map→odom recomputed on load (the JAX load leaves it zero until the
    # next kept scan): pose_at serves the saved run's last pose at once
    t_last, p_last = te.trajectory[-1]
    np.testing.assert_allclose(te.pose_at(t_last)[:2], p_last[:2], atol=1e-6)
    _feed(je, icra, range(CUT, len(ORDER)))
    _feed(te, icra, range(CUT, len(ORDER)))
    je.finish()
    te.finish()
    a, b = je.trajectory_array(), te.trajectory_array()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    d = np.abs(a[:, 1:3] - b[:, 1:3]).max(1)
    outliers = (d > POS_TOL) | (_ang(a[:, 3] - b[:, 3]) > ANG_TOL)
    assert outliers.sum() <= 3, d[outliers]
    assert d.max() <= 0.01, d.max()
    assert te.backend.num_loop_closures == je.backend.num_loop_closures


def test_port_checkpoint_has_the_jax_layout(icra, tmp_path):
    """The port writes the JAX package's keys (all but ``dev_time_origin``)
    with the same shapes, plus its host mirrors of the map offsets, and the
    JAX package loads the file."""
    je = _jax(icra)
    te = _port(icra)
    _feed(je, icra, range(20))
    _feed(te, icra, range(20))
    je._dev_time_origin = None
    jsave(je, str(tmp_path / "j.npz"))
    save_checkpoint(te, str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert set(zt.files) == set(zj.files) - {"dev_time_origin"} | HOST_KEYS
        for k in set(zt.files) - HOST_KEYS:
            if k != "config_json":
                assert zt[k].shape == zj[k].shape, k
    back = jload(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.store.poses_array(), te.store.poses_array())
    np.testing.assert_array_equal(np.asarray(back.state.pub.passes),
                                  te.state.pub.passes.numpy())
    assert back.backend.graph.num_vertices == te.backend.graph.num_vertices


def test_resume_keeps_the_rolling_window_on_its_lattice(tmp_path):
    """Under a narrowed ``configs/real_robot.yaml`` (6 m rolling match-map
    window, de-distortion) on a simulated room loop, a run saved after 30
    scans, before its second recenter, resumes exactly (0.0) as the
    straight-through run goes on. The checkpoint carries the float64 host
    mirrors of the map offsets: resumed from the float32 device offsets
    alone (a file in the JAX package's layout) the next recenter moves the
    maps by a different rounding and the trajectories part."""
    res = 0.05
    occ = np.zeros((int(6 / res), int(8 / res)), bool)
    occ[0, :] = occ[-1, :] = True
    occ[:, 0] = occ[:, -1] = True
    occ[int(2.5 / res):int(3.5 / res), int(3.2 / res):int(4.8 / res)] = True
    occ[int(1.0 / res):int(1.3 / res), int(1.5 / res):int(1.8 / res)] = True
    occ[int(4.6 / res):int(4.9 / res), int(6.0 / res):int(6.3 / res)] = True
    gt = GroundTruthMap(occupancy=occ, free=~occ, resolution=res, origin=np.array([-4.0, -3.0]))
    laser = TLaser(angle_min=-2.2, angle_max=2.2, range_min=0.1, range_max=5.0,
                   num_beams=540, scan_time=0.025)
    log = simulate_log(gt, laser, speed=0.6, scan_rate=5.0, n_waypoints=4, seed=3,
                       range_noise=0.005)
    with open(os.path.join(REPO, "configs", "real_robot.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(max_points=640, match_map_window=4.0)
    cfg_path = str(tmp_path / "rr.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    cfg = T.load_config(cfg_path)
    new = lambda: T.SlamEngine(cfg, laser, world_size=14.0, device="cpu")

    def feed(eng, ks):
        for i in ks:
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))

    n, cut = 88, 30
    straight = new()
    feed(straight, range(n))
    part = new()
    feed(part, range(cut))
    assert part.diag.recenters == 1 and straight.diag.recenters == 2
    path = str(tmp_path / "part.npz")
    save_checkpoint(part, path)
    with np.load(path) as z:
        jax_layout = {k: z[k] for k in z.files if k not in HOST_KEYS}
    assert not np.array_equal(jax_layout["fine_offset"].astype(np.float64), part._host_fine_off)
    np.savez(str(tmp_path / "jax_layout.npz"), **jax_layout)
    trajs = {}
    for name in ("part", "jax_layout"):
        eng = load_checkpoint(str(tmp_path / f"{name}.npz"), device="cpu")
        if name == "part":
            np.testing.assert_array_equal(eng._host_fine_off, part._host_fine_off)
            np.testing.assert_array_equal(eng._host_coarse_off, part._host_coarse_off)
        feed(eng, range(cut, n))
        eng.finish()
        trajs[name] = eng.trajectory_array()
    want = straight.trajectory_array()
    np.testing.assert_array_equal(trajs["part"], want)
    assert trajs["jax_layout"].shape == want.shape
    assert np.abs(trajs["jax_layout"] - want).max() > 0
