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
from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from roborts_slam_tpu_torch.io.pgm import GroundTruthMap
from roborts_slam_tpu_torch.io.simulate import simulate_log
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0, link_scan_max_distance=1.0)
ORDER = list(range(40)) + list(range(39, -1, -1))
TIMES = [0.1 * k for k in range(len(ORDER))]
CUT = 50                      # scans fed before the save: inside the way back
# the port's float64 host mirrors of the map offsets, beside the JAX layout
HOST_KEYS = {"host_pub_offset", "host_coarse_offset", "host_fine_offset"}


# free runs over other stretches of the 120-scan log: start offsets of the
# out-and-back (the first is ORDER's); the tests take FREE_VARIANTS
VARIANTS = (0, 10, 20, 30, 40, 50, 60, 70)
FREE_VARIANTS = VARIANTS[:3]


def _order(start: int) -> list:
    return [start + i for i in ORDER]


def free_run(start: int, pipelined: bool = False) -> tuple:
    """The JAX checkpoint tests' run over the out-and-back from ``start``:
    JAX's engine to ``CUT``, its checkpoint loaded into the port (pipelined
    when asked), both on to the end. (JAX's record, the port's)."""
    import tempfile

    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    order = _order(start)
    je = _jax(d)
    _feed(je, d, range(CUT), order)
    je._dev_time_origin = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax.npz")
        jsave(je, path)
        te = load_checkpoint(path, device="cpu")
    te.pipelined_fetch = pipelined
    _feed(je, d, range(CUT, len(ORDER)), order)
    _feed(te, d, range(CUT, len(ORDER)), order)
    je.finish()
    te.finish()
    return parity.run_record(je, TIMES), parity.run_record(te, TIMES)


@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _port(icra, sync=True):
    return T.SlamEngine(T.load_config(SIM_YAML, **OVER), TLaser.from_array(icra["laser"]),
                        device="cpu", synchronous_backend=sync)


def _jax(icra):
    return J.SlamEngine(J.load_config(SIM_YAML, **OVER), JLaser.from_array(icra["laser"]),
                        synchronous_backend=True, fused_backend=False)


def _feed(eng, icra, ks, order=ORDER):
    for k in ks:
        i = order[k]
        eng.process(icra["ranges"][i], icra["odom"][i], TIMES[k])


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


FORMS = ["lockstep"] + [f"free-{v}" for v in FREE_VARIANTS]


def _jax_checkpoint(icra, path):
    """The JAX engine over the first ``CUT`` scans, its checkpoint written
    to ``path`` (its ``save_checkpoint`` needs the ``_dev_time_origin``
    attribute that its engine never sets: set here)."""
    je = _jax(icra)
    _feed(je, icra, range(CUT))
    je._dev_time_origin = None
    jsave(je, path)
    return je


def _rest(icra):
    """``lockstep``'s feed: the scans after the cut, then ``finish``."""
    return [("process", (icra["ranges"][ORDER[k]], icra["odom"][ORDER[k]], TIMES[k]))
            for k in range(CUT, len(ORDER))] + [("finish", ())]


def _host_offsets_of(te, je):
    """The float64 host offsets from the JAX engine object (its
    checkpoint holds the float32 device offsets only)."""
    for name in ("pub", "coarse", "fine"):
        setattr(te, f"_host_{name}_off", np.array(getattr(je, f"_host_{name}_off"), np.float64))


@pytest.mark.parametrize("form", FORMS)
def test_jax_checkpoint_loads_in_the_port(icra, tmp_path, form):
    """A checkpoint the JAX engine wrote loads in the port with the JAX
    state as it was (``lockstep``), and the port then continues as the
    JAX engine continues: ``lockstep`` from the loaded engine, then with
    JAX's state carried before each of the 30 scans and the finish, at the
    per-step bars (pose 1e-5 m / 1e-5 rad, score, covariance, the same
    links, closure and solve, after it the poses within 1e-3, map cells),
    at most 3 tie flips; ``free-<start>``: both free from the cut of the
    out-and-back from that offset, at the bars of a whole run (closures and
    solves equal, kept within one scan, RMS gap to JAX within 5 mm; the
    count of poses beyond 2e-3 m printed)."""
    if form != "lockstep":
        L.assert_free(*free_run(int(form.split("-")[1])), f"checkpoint {form}")
        return
    path = str(tmp_path / "jax.npz")
    je = _jax_checkpoint(icra, path)
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
    _host_offsets_of(te, je)
    rep = L.lockstep(je, _rest(icra), name="checkpoint", first=te)
    L.assert_lockstep(rep)
    assert rep.rows[-1]["closures"][0] >= 1 and rep.rows[-1]["solves"][0] >= 1


def test_port_checkpoint_has_the_jax_layout(icra, tmp_path):
    """The port writes the JAX package's keys (``dev_time_origin``, the
    pipelined step's device clock, among them) with the same shapes, plus
    its host mirrors of the map offsets, and the JAX package loads the
    file."""
    je = _jax(icra)
    te = _port(icra)
    _feed(je, icra, range(20))
    _feed(te, icra, range(20))
    je._dev_time_origin = None
    jsave(je, str(tmp_path / "j.npz"))
    save_checkpoint(te, str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert set(zt.files) == set(zj.files) | HOST_KEYS
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


def test_checkpoint_resume_under_pipeline(icra, tmp_path):
    """(JAX ``test_engine_features.py:813-844``) A checkpoint taken in the
    middle of a pipelined run (the save drains the scans in flight) resumes
    into pipelined mode with the device move-gate clock seeded: the resumed
    run equals a straight-through pipelined run within 1e-4."""
    straight = _port(icra)
    straight.pipelined_fetch = True
    _feed(straight, icra, range(len(ORDER)))
    straight.finish()
    part = _port(icra)
    part.pipelined_fetch = True
    _feed(part, icra, range(CUT))
    path = str(tmp_path / "pipe.npz")
    save_checkpoint(part, path)
    assert not part._inflight
    resumed = load_checkpoint(path, device="cpu")
    assert resumed._dev_time_origin == part._dev_time_origin == TIMES[0]
    assert float(resumed.state.last_step_time) == np.float32(TIMES[CUT - 1] - TIMES[0])
    assert resumed._prev_process_time == TIMES[CUT - 1]
    resumed.pipelined_fetch = True
    _feed(resumed, icra, range(CUT, len(ORDER)))
    resumed.finish()
    assert resumed.diag.fused_steps > 0 and straight.backend.num_loop_closures >= 1
    assert len(resumed.store) == len(straight.store)
    np.testing.assert_allclose(resumed.trajectory_array(), straight.trajectory_array(),
                               atol=1e-4)
    assert resumed.backend.num_links == straight.backend.num_links


@pytest.mark.parametrize("form", FORMS)
def test_jax_checkpoint_loads_into_a_pipelined_port(icra, tmp_path, form):
    """A checkpoint written by the JAX package loads into a pipelined port
    engine (no ``dev_time_origin`` in it: the device clock counts from the
    last processed stamp), which continues as the port's blocking engine
    loaded from the same file does (1e-4; ``lockstep``). Against the JAX
    engine: ``lockstep`` holds the mode's blocking form, the port carried
    into JAX's state before each scan, at the per-step bars (at most 3 tie
    flips); ``free-<start>``: the pipelined port free from the cut of the
    out-and-back from that offset, at the bars of a whole run (closures and
    solves equal, kept within one scan, RMS gap to JAX within 5 mm)."""
    if form != "lockstep":
        L.assert_free(*free_run(int(form.split("-")[1]), pipelined=True),
                      f"pipelined checkpoint {form}")
        return
    path = str(tmp_path / "jax.npz")
    je = _jax_checkpoint(icra, path)
    runs = {}
    for pipelined in (False, True):
        te = load_checkpoint(path, device="cpu")
        assert te._dev_time_origin == TIMES[CUT - 1]
        te.pipelined_fetch = pipelined
        _feed(te, icra, range(CUT, len(ORDER)))
        te.finish()
        runs[pipelined] = te
    b, p = runs[False].trajectory_array(), runs[True].trajectory_array()
    np.testing.assert_allclose(p, b, atol=1e-4)
    assert runs[True].backend.num_loop_closures == runs[False].backend.num_loop_closures >= 1
    first = load_checkpoint(path, device="cpu")
    _host_offsets_of(first, je)
    L.assert_lockstep(L.lockstep(je, _rest(icra), name="pipelined checkpoint", first=first))
