"""Port vs JAX package: the online engine. Corrections that arrive with
fewer poses than stored scans, the pose stream (``pose_at``), the
live-output hooks, the asynchronous back-end worker (``synchronous_backend=
False``), ``warm_backend``, the stage timers and the launch counters under
two threads. Inputs: ``tests/data/golden_icra.npz`` under
``configs/simulation.yaml`` at the narrow size of ``test_torch_engine.py``,
and a two-lap loop round a block in a simulated room."""

import collections
import inspect
import os
import sys
import threading

import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu_torch as T
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.io.pgm import GroundTruthMap
from roborts_slam_tpu_torch.io.simulate import path_to_trajectory, simulate_log
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser
from roborts_slam_tpu_torch.utils.evaluation import ate_rmse, match_by_time
from roborts_slam_tpu_torch.utils.profiling import StageTimers, trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0)
POS_TOL = ANG_TOL = 2e-3       # the engine bar of test_torch_engine.py
STAGES = {"frontend_step", "frontend_fetch", "backend_update", "backend_loop_closure"}
# the port's six stages that tile a blocking ``process()`` call, and the
# parts of them it also times
TOP_STAGES = {"ingest", "frontend_prepare", "frontend_step", "frontend_commit",
              "backend_update", "backend_loop_closure"}
PART_STAGES = {"dispatch_stage", "dispatch_lookup", "dispatch_replay", "frontend_fetch",
               "recenter", "closure_solve", "closure_correct"}


@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _engines(icra, sync=True, **over):
    """A JAX engine (blocking, unfused) and a port engine on the CPU under
    the narrowed simulation profile."""
    je = J.SlamEngine(J.load_config(SIM_YAML, **OVER, **over),
                      JLaser.from_array(icra["laser"]),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.load_config(SIM_YAML, **OVER, **over),
                      TLaser.from_array(icra["laser"]), device="cpu",
                      synchronous_backend=sync)
    return je, te


def _port(icra, sync=True, **over):
    return T.SlamEngine(T.load_config(SIM_YAML, **OVER, **over),
                        TLaser.from_array(icra["laser"]), device="cpu",
                        synchronous_backend=sync)


def _feed(eng, icra, ids, times=None):
    for k, i in enumerate(ids):
        t = float(icra["times"][i]) if times is None else times[k]
        eng.process(icra["ranges"][i], icra["odom"][i], t)


def _ang(a):
    return np.abs(np.arctan2(np.sin(a), np.cos(a)))


OUT_AND_BACK = list(range(40)) + list(range(39, -1, -1))
OAB_TIMES = [0.1 * k for k in range(len(OUT_AND_BACK))]


@pytest.fixture(scope="module")
def sync_out_and_back(icra):
    """40 scans out and the same 40 back with the link radius cut to 1 m
    (chain matches, one loop closure, an SPA solve and a full rebuild), on
    the port's blocking engine."""
    eng = _port(icra, link_scan_max_distance=1.0)
    _feed(eng, icra, OUT_AND_BACK, OAB_TIMES)
    eng.finish()
    # chain batches: the separate ones and those that rode a fused step
    assert eng.backend.num_loop_closures >= 1
    assert eng.backend.num_chain_dispatches + eng.diag.fused_steps > 10
    return eng


# ---- corrections with fewer poses than scans ----

def test_apply_corrections_reanchors_trailing_scans_like_jax(icra):
    """``_apply_corrections`` given poses for the first n − 3 stored scans
    (the asynchronous worker's case): both packages carry the trailing three
    scans by the rigid delta of the last corrected one, rebuild the maps and
    refresh map→odom. From identical stored poses the two agree to 1e-9."""
    je, te = _engines(icra)
    _feed(je, icra, range(12))
    _feed(te, icra, range(12))
    n = len(te.store)
    assert n == len(je.store) >= 8
    for k, p in enumerate(je.store.poses):           # start from the same poses
        te.store.set_pose(k, p)
        te.trajectory[k] = (te.trajectory[k][0], np.asarray(p, np.float64).copy())
    before = je.store.poses_array().copy()
    dth, tr = 0.12, np.array([0.35, -0.2])
    c, s = np.cos(dth), np.sin(dth)
    delta = lambda p: np.array([tr[0] + c * p[0] - s * p[1],
                                tr[1] + s * p[0] + c * p[1], p[2] + dth])
    corrected = np.stack([delta(before[k]) for k in range(n - 3)])
    je._apply_corrections(corrected)
    te._apply_corrections(corrected)
    got, want = te.store.poses_array(), je.store.poses_array()
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-9, rtol=0)
    assert _ang(got[:, 2] - want[:, 2]).max() < 1e-9
    for k in range(n):                               # the trailing scans included
        np.testing.assert_allclose(got[k, :2], delta(before[k])[:2], atol=1e-9, rtol=0)
        assert _ang(got[k, 2] - delta(before[k])[2]) < 1e-9
    np.testing.assert_allclose(te.trajectory_array(), je.trajectory_array(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(te._host_pose, je._host_pose, atol=1e-9, rtol=0)
    np.testing.assert_allclose(te._map_to_odom, je._map_to_odom, atol=1e-9, rtol=0)
    np.testing.assert_allclose(te.state.pose.numpy(), np.asarray(je.state.pose), atol=0)
    jm, tm = je.get_pub_map(), te.get_pub_map()
    assert jm.shape == tm.shape and (tm == 100).any()
    assert (jm != tm).mean() <= 0.005                # wall-edge cells (test_torch_engine.py)


# ---- the pose stream ----

@pytest.fixture(scope="module")
def streamed(icra):
    """40 scans through both engines; the port's on_pose hook reads
    ``pose_at`` at the stamp of the scan it was just given."""
    je, te = _engines(icra)
    at_hook = []
    te.on_pose = lambda t, p: at_hook.append((t, p, te.pose_at(t)))
    _feed(je, icra, range(40))
    _feed(te, icra, range(40))
    return je, te, at_hook


def test_pose_at_matches_jax(streamed):
    """At every kept stamp and at the midpoint of every pair of odometry
    samples the two pose streams agree within the engine bar."""
    je, te, _ = streamed
    kept = [t for t, _ in te.trajectory]
    assert kept == [t for t, _ in je.trajectory]
    ot = [h[0] for h in te._odom_history]
    stamps = kept + [0.5 * (a + b) for a, b in zip(ot, ot[1:])] + [ot[-1] + 1.0]
    for t in stamps:
        a, b = je.pose_at(t), te.pose_at(t)
        assert np.isfinite(b).all()
        assert np.abs(a[:2] - b[:2]).max() <= POS_TOL and _ang(a[2] - b[2]) <= ANG_TOL, (t, a, b)


def test_pose_at_kept_stamps_equals_trajectory(streamed):
    """When a scan is kept, ``pose_at`` at its stamp is its pose (1e-6);
    between two odometry samples the stream moves between their poses."""
    _, te, at_hook = streamed
    assert len(at_hook) == len(te.trajectory) >= 30
    for (t, pose, streamed_pose), (t2, kept_pose) in zip(at_hook, te.trajectory):
        assert t == t2
        np.testing.assert_allclose(streamed_pose[:2], kept_pose[:2], atol=1e-6)
        assert _ang(streamed_pose[2] - kept_pose[2]) <= 1e-6
    (t0, _), (t1, _) = te._odom_history[-2], te._odom_history[-1]
    pa, pm, pb = te.pose_at(t0), te.pose_at(0.5 * (t0 + t1)), te.pose_at(t1)
    assert ((pm[:2] >= np.minimum(pa[:2], pb[:2]) - 1e-9)
            & (pm[:2] <= np.maximum(pa[:2], pb[:2]) + 1e-9)).all()


def test_pose_at_jumps_with_a_correction(icra):
    """A correction moves map→odom at once: ``pose_at`` at the last kept
    stamp follows the corrected pose in both packages."""
    je, te = _engines(icra)
    _feed(je, icra, range(20))
    _feed(te, icra, range(20))
    t_k, p_k = te.trajectory[-1]
    shift = np.array([0.35, -0.2, 0.1])
    for eng in (je, te):
        eng._apply_corrections(np.stack([np.asarray(p) + shift for p in eng.store.poses]))
    a, b = je.pose_at(t_k), te.pose_at(t_k)
    np.testing.assert_allclose(b[:2], (p_k + shift)[:2], atol=1e-5)
    assert np.abs(a[:2] - b[:2]).max() <= POS_TOL and _ang(a[2] - b[2]) <= ANG_TOL


# ---- hooks ----

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_hooks_fire_on_the_calling_thread(icra, mode):
    """``on_pose`` per kept scan, ``on_map_snapshot`` every fifth, on the
    thread that called ``process`` and with the grid ``get_pub_map`` gives
    at that moment; counts as the JAX engine's, grids within 0.5 %."""
    je, te = _engines(icra, sync=mode == "sync")
    seen = {}
    for name, eng in (("j", je), ("t", te)):
        rec = seen[name] = {"poses": [], "snaps": [], "threads": set()}
        eng.map_snapshot_every = 5

        def on_pose(t, p, rec=rec):
            rec["poses"].append((t, p))
            rec["threads"].add(threading.get_ident())

        def on_snap(n, grid, rec=rec, eng=eng):
            rec["snaps"].append((n, grid, eng.get_pub_map()))
            rec["threads"].add(threading.get_ident())

        eng.on_pose, eng.on_map_snapshot = on_pose, on_snap
        _feed(eng, icra, range(30))
        eng.finish()
    kept = len(te.store)
    assert kept == len(je.store) >= 25
    assert len(seen["t"]["poses"]) == len(seen["j"]["poses"]) == kept
    assert len(seen["t"]["snaps"]) == len(seen["j"]["snaps"]) == kept // 5
    assert seen["t"]["threads"] == {threading.get_ident()}
    for (n, grid, now), (jn, jgrid, _) in zip(seen["t"]["snaps"], seen["j"]["snaps"]):
        assert n == jn and n % 5 == 0
        assert set(np.unique(grid)) <= {-1, 0, 100}
        np.testing.assert_array_equal(grid, now)
        assert grid.shape == jgrid.shape and (grid != jgrid).mean() <= 0.005
    np.testing.assert_array_equal([p for _, p in seen["t"]["poses"]],
                                  te.trajectory_array()[:, 1:])


# ---- the asynchronous back end ----

def test_async_finish_after_every_scan_equals_sync(icra, sync_out_and_back):
    """A worker drained after every scan does what the blocking back end
    does, bit for bit: same graph, trajectory and map."""
    a = _port(icra, sync=False, link_scan_max_distance=1.0)
    for k, i in enumerate(OUT_AND_BACK):
        a.process(icra["ranges"][i], icra["odom"][i], OAB_TIMES[k])
        a.finish()
        assert a._backend_thread is None
    s = sync_out_and_back
    np.testing.assert_array_equal(a.trajectory_array(), s.trajectory_array())
    edges = lambda e: [(g.source, g.target) for g in e.backend.graph.edges]
    assert edges(a) == edges(s)
    assert (a.backend.num_loop_closures, a.backend.num_links, a.backend.num_solves) == \
        (s.backend.num_loop_closures, s.backend.num_links, s.backend.num_solves)
    np.testing.assert_array_equal(a.get_pub_map(), s.get_pub_map())
    assert a.diag.backend_batch_max == 1


def room_loop_log(laps=1.35, seed=4):
    """A loop round the block of an 8 m x 6 m room (5 m lidar, 270 beams)
    driven ``laps`` times at 0.8 m/s, 5 scans a second, with odometry error."""
    res = 0.05
    occ = np.zeros((int(6 / res), int(8 / res)), bool)
    occ[0, :] = occ[-1, :] = True
    occ[:, 0] = occ[:, -1] = True
    occ[int(2.5 / res):int(3.5 / res), int(3.2 / res):int(4.8 / res)] = True
    occ[int(1.0 / res):int(1.3 / res), int(1.5 / res):int(1.8 / res)] = True
    occ[int(4.6 / res):int(4.9 / res), int(6.0 / res):int(6.3 / res)] = True
    gt = GroundTruthMap(occupancy=occ, free=~occ, resolution=res,
                        origin=np.array([-4.0, -3.0]))
    laser = TLaser(angle_min=-2.2, angle_max=2.2, range_min=0.1, range_max=5.0,
                   num_beams=270)
    corners = np.array([[0, -1.3], [2.6, -1.3], [2.6, 1.3], [-2.6, 1.3],
                        [-2.6, -1.3], [0, -1.3]])
    lap = np.concatenate([np.linspace(corners[i], corners[i + 1], 60, endpoint=False)
                          for i in range(5)])
    path = np.concatenate([lap] * int(laps) + [lap[:int(len(lap) * (laps % 1))]])
    return simulate_log(gt, laser, trajectory=path_to_trajectory(path, 0.8, 5.0),
                        range_noise=0.005, odom_error=(0.05, 0.05, 0.08), seed=seed)


def test_async_free_running_passes_the_quality_bar():
    """The worker left to drain as it will over a loop that closes: the JAX
    package's bar (test_engine_features.py::test_async_backend_pipeline),
    ATE < max(2 × the JAX blocking engine's ATE, 0.15 m)."""
    log = room_loop_log()
    over = dict(fine_map_resolution=0.02, world_size=14.0, max_points=320,
                link_scan_max_distance=1.5)
    jl = JLaser.from_array(log.laser.to_array())
    je = J.SlamEngine(J.load_config(SIM_YAML, **over), jl,
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.load_config(SIM_YAML, **over), log.laser, device="cpu",
                      synchronous_backend=False)
    ate = {}
    for name, eng in (("j", je), ("t", te)):
        est, gt = match_by_time(eng.run_log(log), log.gt_poses, log.times)
        ate[name] = ate_rmse(est, gt)
    assert te._backend_thread is None
    assert te.backend.num_loop_closures >= 1 and te.backend.num_links > len(te.store)
    assert len(te.trajectory) == len(te.store) == te.backend.graph.num_vertices
    assert ate["t"] < max(2.0 * ate["j"], 0.15), ate


def test_finish_is_not_terminal(icra):
    """finish() joins the worker; the next kept scan starts it again and
    the back end goes on linking."""
    eng = _port(icra, sync=False)
    _feed(eng, icra, range(30))
    first = eng._backend_thread
    eng.finish()
    assert eng._backend_thread is None and not first.is_alive()
    links = eng.backend.num_links
    assert links > 0 and eng.backend.graph.num_vertices == len(eng.store)
    _feed(eng, icra, range(30, 60))
    assert eng._backend_thread is not None and eng._backend_thread is not first
    eng.finish()
    assert eng.backend.num_links > links
    assert eng.backend.graph.num_vertices == len(eng.store) == len(eng.trajectory)


def test_async_stress_slow_corrections(icra):
    """The shape of the JAX package's test of the same name: a solve and a
    correction after every drained batch, each held 50 ms before it is
    applied, so that the front end streams scans into the store while
    corrections from stale snapshots land (re-anchoring). After finish()
    every structure the two threads share agrees with the others."""
    eng = _port(icra, sync=False, link_scan_max_distance=1.0)
    orig_try = eng.backend.try_close_loop

    def eager_try(scan_id, prematched=None):
        out = orig_try(scan_id, prematched=prematched)
        eng.backend.force_optimize()          # a correction on every batch
        return out

    eng.backend.try_close_loop = eager_try
    applied, trailing = [0], [0]

    def slow_apply(corrected):
        threading.Event().wait(0.05)          # let the front end race ahead
        applied[0] += 1
        trailing[0] += corrected.shape[0] < len(eng.store)
        eng._apply_corrections(corrected)

    eng.backend.on_corrections = slow_apply
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        _feed(eng, icra, OUT_AND_BACK, OAB_TIMES)
        eng.finish()
    finally:
        sys.setswitchinterval(interval)
    assert applied[0] >= 2 and trailing[0] >= 1, (applied, trailing)
    assert eng.diag.backend_batch_max > 1
    n = len(eng.store)
    assert len(eng.trajectory) == n == eng.backend.graph.num_vertices
    traj = eng.trajectory_array()
    np.testing.assert_array_equal(traj[:, 1:], eng.store.poses_array())
    # the device mirror tracks the host store through the races
    pts, msk, poses = eng.store.device_arrays()
    np.testing.assert_array_equal(pts[:n].numpy(), np.stack(eng.store._points))
    np.testing.assert_array_equal(msk[:n].numpy(), np.stack(eng.store._masks))
    np.testing.assert_array_equal(poses[:n].numpy(),
                                  eng.store.poses_array().astype(np.float32))
    np.testing.assert_allclose(eng.store.barycenters(), eng.store._bary_of(range(n)),
                               atol=1e-12)
    # the worker's pub snapshot is a clone with the live map's content
    pub_spec, hits, passes, off = eng.store.pub_map_arrays()
    assert hits is not eng.state.pub.hits
    assert hits.data_ptr() != eng.state.pub.hits.data_ptr()
    np.testing.assert_array_equal(hits.numpy(), eng.state.pub.hits.numpy())
    np.testing.assert_array_equal(passes.numpy(), eng.state.pub.passes.numpy())
    np.testing.assert_array_equal(off.numpy(), eng.state.pub.offset.numpy())
    assert pub_spec == eng.fspec.pub_spec
    _feed(eng, icra, range(40, 45))           # usable after finish()
    eng.finish()
    assert np.isfinite(eng.trajectory_array()).all()


@pytest.mark.parametrize("where", ["finish", "process"])
def test_worker_exception_is_raised_again(icra, where):
    """An exception on the worker does not vanish: it ends the worker, and
    the next ``finish`` or ``process`` raises it."""
    eng = _port(icra, sync=False)
    orig = eng.backend.update_graph

    def failing(scan_id, cov, prematched=None):
        if scan_id == 5:
            raise ValueError("graph update failed at scan 5")
        return orig(scan_id, cov, prematched=prematched)

    eng.backend.update_graph = failing
    _feed(eng, icra, range(6))                 # scan 5 is the last one queued
    assert len(eng.store) == 6
    eng._backend_thread.join(timeout=120)
    assert not eng._backend_thread.is_alive()
    with pytest.raises(ValueError, match="scan 5"):
        if where == "finish":
            eng.finish()
        else:
            _feed(eng, icra, [8])
    with pytest.raises(ValueError, match="scan 5"):     # and it stays raised
        eng.finish()


# ---- warm-up, timers, launch counts ----

def test_warm_backend_is_side_effect_free(icra):
    """``warm_backend`` (the JAX package's signature) changes no state: a
    run continued after warming equals the unwarmed run bit for bit."""
    jparams = list(inspect.signature(J.SlamEngine.warm_backend).parameters)
    assert list(inspect.signature(T.SlamEngine.warm_backend).parameters) == jparams
    order = list(range(20)) + list(range(19, -1, -1))
    times = [0.1 * k for k in range(len(order))]
    plain = _port(icra, link_scan_max_distance=1.0)
    warmed = _port(icra, link_scan_max_distance=1.0)
    for eng in (plain, warmed):
        for k in range(12):
            eng.process(icra["ranges"][order[k]], icra["odom"][order[k]], times[k])
    before = (warmed.backend.num_chain_dispatches, warmed.backend.num_solves,
              len(warmed.backend.graph.edges), warmed.store.poses_array().copy())
    pub = warmed.get_pub_map()
    warmed.warm_backend(solver_buckets=(64,), match_buckets=(1, 2, 4, 8))
    assert (warmed.backend.num_chain_dispatches, warmed.backend.num_solves,
            len(warmed.backend.graph.edges)) == before[:3]
    np.testing.assert_array_equal(warmed.store.poses_array(), before[3])
    np.testing.assert_array_equal(warmed.get_pub_map(), pub)
    for eng in (plain, warmed):
        for k in range(12, len(order)):
            eng.process(icra["ranges"][order[k]], icra["odom"][order[k]], times[k])
        eng.finish()
    assert plain.backend.num_chain_dispatches > 0
    np.testing.assert_array_equal(plain.trajectory_array(), warmed.trajectory_array())
    np.testing.assert_array_equal(plain.get_pub_map(), warmed.get_pub_map())
    assert (plain.backend.num_links, plain.backend.num_chain_dispatches) == \
        (warmed.backend.num_links, warmed.backend.num_chain_dispatches)


def test_stage_timers_carry_the_jax_stage_names(icra, tmp_path):
    """The port times the JAX engine's four stages among its own: its
    top-level stages are exactly the six that tile ``process()``; the
    worker's stages are counted apart from the front end's. ``trace``
    writes a Chrome trace holding a stage's span."""
    je, te = _engines(icra)
    ta = _port(icra, sync=False)
    for eng in (je, te, ta):
        _feed(eng, icra, range(6))
        eng.finish()
    assert set(je.timers.stages) == STAGES
    for eng in (te, ta):
        assert STAGES <= set(eng.timers.stages)
        assert set(eng.timers.stages) - PART_STAGES == TOP_STAGES
        st = eng.timers.stages
        assert st["frontend_step"].count == st["frontend_fetch"].count == 6
        assert st["backend_update"].count == st["backend_loop_closure"].count \
            == eng.diag.backend_batches >= 1
        assert "frontend_step" in eng.timers.report()
    timers = StageTimers()
    with trace(str(tmp_path)), timers.stage("six_scans"):
        _feed(_port(icra), icra, range(3))
    assert timers.as_dict()["six_scans"]["count"] == 1
    with open(tmp_path / "trace.json") as f:
        assert "slam.six_scans" in f.read()
    with trace(None) as off:
        assert off is None


def test_launch_counts_lose_nothing_across_threads():
    """The kernel wrappers count launches under one lock: eight threads
    counting at once, with the interpreter switching threads every 1e-6 s,
    lose no count."""
    from roborts_slam_tpu_torch.ops.cuda import correlation, raycarve

    kept = {(m, n): getattr(m, n) for m, ns in (
        (correlation, ("launches", "launches_v2", "launch_shapes")),
        (raycarve, ("mark_launches", "check_launches", "mark_shapes", "check_shapes")))
        for n in ns}
    correlation.launches = correlation.launches_v2 = 0
    raycarve.mark_launches = raycarve.check_launches = 0
    correlation.launch_shapes = collections.Counter()
    raycarve.mark_shapes, raycarve.check_shapes = collections.Counter(), collections.Counter()
    per, n_threads = 5000, 8

    def count():
        for _ in range(per):
            correlation._count(1, (1, 1, 21, 200, 3, 640, 640))
            correlation._count(2, (2, 1, 21, 200, 3, 640, 640))
            raycarve._count_mark((1152, 640, 640))
            raycarve._count_check((1, 100, 640, 640))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        total = per * n_threads
        assert correlation.launches == correlation.launches_v2 == total
        assert raycarve.mark_launches == raycarve.check_launches == total
        assert list(correlation.launch_shapes.values()) == [total, total]
        assert list(raycarve.mark_shapes.values()) == [total]
        assert list(raycarve.check_shapes.values()) == [total]
    finally:
        sys.setswitchinterval(interval)
        for (m, n), v in kept.items():
            setattr(m, n, v)
