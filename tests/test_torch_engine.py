"""Port vs JAX package: the slice as a whole. The first 40 scans of the icra
log go through both engines (blocking, unfused: both pinned to
``fused_backend=False``, the separate chain batches whose count is compared)
with the shipped simulation profile at a small size, followed by a forced
graph optimisation."""

import functools
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu_torch as T
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.convert import store_from_jax
from roborts_slam_tpu_torch.engine import ScanStore
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser
from tests import _torch_lockstep as L

# one thread: float sums are then taken in one fixed order on any machine
# (these replays amplify last-bit differences, see the tolerances below)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0)
N_SCANS = 40
SUPER_FINE_STEP = 0.01         # m, one super-fine candidate step


# free runs over other stretches of the 120-scan log: start offsets (the
# first is the fixtures' own stretch); the tests take FREE_VARIANTS
VARIANTS = (0, 10, 20, 30, 40, 50, 60, 70)
FREE_VARIANTS = VARIANTS[:3]


def _icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _pair(d, over=OVER):
    """Both engines as the fixtures build them (blocking, unfused)."""
    je = J.SlamEngine(J.load_config(SIM_YAML, **over), JLaser.from_array(d["laser"]),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.load_config(SIM_YAML, **over), TLaser.from_array(d["laser"]),
                      device="cpu", fused_backend=False)
    return je, te


def free_run(start: int) -> dict:
    """``engines``' run over the 40 scans from ``start``: both engines free,
    then a forced graph optimisation. {phase: (JAX's record, the port's)}
    with phase ``before_optimize`` / ``after_optimize``."""
    d = _icra()
    je, te = _pair(d)
    fed = list(range(start, start + N_SCANS))
    for i in fed:
        for eng in (je, te):
            eng.process(d["ranges"][i], d["odom"][i], float(d["times"][i]))
    times = d["times"][fed]
    out = {"before_optimize": (parity.run_record(je, times), parity.run_record(te, times))}
    je.force_graph_optimize()
    te.force_graph_optimize()
    out["after_optimize"] = (parity.run_record(je, times), parity.run_record(te, times))
    return out


@pytest.fixture(scope="module")
def engines():
    """``free_run(0)``'s engines, kept: (JAX's, the port's, kept fed ids,
    the trajectories before the optimisation, ``free_run``'s records)."""
    d = _icra()
    je, te = _pair(d)
    kept = {"j": [], "t": []}
    for i in range(N_SCANS):
        args = (d["ranges"][i], d["odom"][i], float(d["times"][i]))
        if je.process(*args):
            kept["j"].append(i)
        if te.process(*args):
            kept["t"].append(i)
    pre = (je.trajectory_array(), te.trajectory_array())
    times = d["times"][:N_SCANS]
    recs = {"before_optimize": (parity.run_record(je, times), parity.run_record(te, times))}
    je.force_graph_optimize()
    te.force_graph_optimize()
    recs["after_optimize"] = (parity.run_record(je, times), parity.run_record(te, times))
    return je, te, kept, pre, recs


@pytest.fixture(scope="module")
def lockstep_run():
    """The fixtures' 40 scans and the forced optimisation in lockstep: the
    JAX engine's state carried into the port before each."""
    d = _icra()
    je = _pair(d)[0]
    feed = L.scans(d["ranges"][:N_SCANS], d["odom"][:N_SCANS], d["times"][:N_SCANS])
    return L.lockstep(je, feed + [("force_graph_optimize", ())], name="engine",
                      fused_backend=False)


@functools.lru_cache(maxsize=None)
def _free(start):
    return free_run(start)


def _traj_diff(a, b):
    d = np.abs(a - b)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    return d


def test_same_kept_scans_links_and_loops(engines):
    je, te, kept, *_ = engines
    assert kept["t"] == kept["j"] and len(kept["t"]) >= 30
    assert te.backend.num_links == je.backend.num_links > 0
    assert te.backend.num_loop_closures == je.backend.num_loop_closures
    assert te.backend.num_solves == je.backend.num_solves == 1
    assert te.backend.graph.num_vertices == je.backend.graph.num_vertices
    assert len(te.backend.graph.edges) == len(je.backend.graph.edges)
    assert te.diag.scans_processed == je.diag.scans_processed
    assert te.diag.scans_dropped_gate == je.diag.scans_dropped_gate


@pytest.mark.parametrize("form", ["lockstep"] + [f"free-{v}" for v in FREE_VARIANTS])
@pytest.mark.parametrize("when", ["before_optimize", "after_optimize"])
def test_trajectories_agree(engines, lockstep_run, when, form):
    """``lockstep``: each of the 40 steps, and the forced optimisation,
    from JAX's carried state at the per-step bars (pose 1e-5 m / 1e-5 rad,
    score, covariance, decisions, map cells; after the solve the poses
    within 1e-3), at most 3 tie flips. ``free-<start>``: both engines free
    over the 40 scans from that offset, at the bars of a whole run: the
    same closure and solve counts, the kept count within one scan, the RMS
    gap to JAX's trajectory on shared kept scans within 5 mm. The
    tie-averaged pose jumps by a fraction of a candidate step when the
    last f32 bits move one candidate across the tie line, and each pose
    seeds the next prediction: a free run parts by such flips wherever
    they fall (PERF.md §7 item 12), so its count of poses beyond 2e-3 m is
    printed, not held."""
    if form == "lockstep":
        rep = parity.LockstepReport(f"engine {when}")
        rep.rows = lockstep_run.rows[:N_SCANS] if when == "before_optimize" else lockstep_run.rows
        L.assert_lockstep(rep)
        if when == "after_optimize":
            row = rep.rows[-1]
            assert row["solves"] == [1, 1] and row["maps_rebuilt"]
        return
    start = int(form.split("-")[1])
    jrec, trec = (engines[4] if start == 0 else _free(start))[when]
    assert np.isfinite(trec["poses"]).all()
    report = L.assert_free(jrec, trec, f"engine {when} {form}")
    assert report["kept"]["port"] >= 30


def test_pub_maps_agree(engines):
    je, te, *_ = engines
    jm, tm = je.get_pub_map(), te.get_pub_map()
    assert jm.shape == tm.shape and tm.dtype == np.int32
    assert (tm == 100).any() and (tm == 0).any() and (tm == -1).any()
    # cells differ only along wall edges, where sub-cell pose differences
    # move ray endpoints across a cell boundary
    assert (jm != tm).mean() <= 0.005


def test_store_and_graph_contents_agree(engines):
    je, te, *_ = engines
    n = len(te.store)
    assert n == len(je.store)
    np.testing.assert_array_equal(np.stack(te.store._points), np.stack(je.store._points))
    np.testing.assert_array_equal(te.store._n_valid, je.store._n_valid)
    np.testing.assert_allclose(te.store.barycenters(), je.store.barycenters(), atol=1e-2)
    pts, msk, poses = te.store.device_arrays()
    np.testing.assert_allclose(poses[:n].numpy(), te.store.poses_array(), atol=1e-6)
    np.testing.assert_array_equal(pts[:n].numpy(), np.stack(te.store._points))
    # the JAX store's contents carried across
    carried = store_from_jax(dict(
        points=np.stack(je.store._points), masks=np.stack(je.store._masks),
        n_valid=np.array(je.store._n_valid), poses=je.store.poses_array(),
        odoms=np.asarray(je.store.odoms), times=np.array(je.store.times)),
        je.store.max_points, "cpu")
    assert isinstance(carried, ScanStore) and len(carried) == n
    np.testing.assert_allclose(carried.barycenters(), je.store.barycenters(), atol=1e-12)
    assert carried.n_valid(3) == je.store._n_valid[3]


@pytest.fixture(scope="module")
def out_and_back():
    """40 scans out and the same 40 back, with the link radius cut to 1 m so
    that the graph itself proposes near chains and a loop closure: the back
    end's chain matches, the two-stage loop verification, the SPA solve and
    the post-closure rebuild of all maps run inside the loop."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    over = dict(OVER, link_scan_max_distance=1.0)
    je = J.SlamEngine(J.load_config(SIM_YAML, **over), JLaser.from_array(d["laser"]),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.load_config(SIM_YAML, **over), TLaser.from_array(d["laser"]),
                      device="cpu", fused_backend=False)
    order = list(range(N_SCANS)) + list(range(N_SCANS - 1, -1, -1))
    kept = {}
    for name, eng in (("j", je), ("t", te)):
        kept[name] = [k for k, i in enumerate(order)
                      if eng.process(d["ranges"][i], d["odom"][i], 0.1 * k)]
    return je, te, kept


def test_out_and_back_same_graph(out_and_back):
    je, te, kept = out_and_back
    assert kept["t"] == kept["j"]
    jb, tb = je.backend, te.backend
    assert tb.num_chain_dispatches == jb.num_chain_dispatches > 10
    assert tb.num_loop_closures == jb.num_loop_closures >= 1
    assert tb.num_solves == jb.num_solves >= 1
    assert tb.num_links == jb.num_links > len(kept["t"])       # more than odometry links
    edges = lambda b: sorted((e.source, e.target) for e in b.graph.edges)
    assert edges(tb) == edges(jb)


def test_out_and_back_trajectories_agree(out_and_back):
    je, te, _ = out_and_back
    a, b = je.trajectory_array(), te.trajectory_array()
    assert a.shape == b.shape and np.isfinite(b).all()
    d = _traj_diff(a, b)
    # after a loop closure the SPA solve redistributes the closure error by
    # the edges' information matrices, whose angular entry comes from the
    # matcher's angular variance — a discontinuous function of the last f32
    # bits (test_torch_matchers_frontend.py). Typical agreement stays at
    # 1e-4 m; single scans may differ by up to one super-fine candidate
    # step, 0.01 m / 0.01 rad.
    assert np.median(d[:, 1:3].max(1)) <= 1e-3 and np.median(d[:, 3]) <= 1e-3
    assert d[:, 1:3].max() <= SUPER_FINE_STEP and d[:, 3].max() <= 1e-2, d.max(0)
    jm, tm = je.get_pub_map(), te.get_pub_map()
    assert jm.shape == tm.shape and (jm != tm).mean() <= 0.01


def test_run_log_and_process_points():
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))

    class Log:
        ranges, odom, times = d["ranges"][:6], d["odom"][:6], d["times"][:6]

        def __len__(self):
            return 6

    cfg = T.load_config(SIM_YAML, fine_map_resolution=0.05, world_size=20.0)
    a = T.SlamEngine(cfg, TLaser.from_array(d["laser"]), device="cpu")
    traj = a.run_log(Log())
    b = T.SlamEngine(cfg, TLaser.from_array(d["laser"]), device="cpu")
    from roborts_slam_tpu_torch.models.scan import ranges_to_packed
    for i in range(6):
        b.process_points(*ranges_to_packed(d["ranges"][i], b.laser, cfg.max_points),
                         d["odom"][i], float(d["times"][i]))
    b.finish()
    np.testing.assert_array_equal(traj, b.trajectory_array())
    assert traj.shape == (len(a.store), 4) and len(a.store) >= 5
    nodes, edges = a.backend.graph_info()
    assert nodes.shape == (len(a.store), 2) and len(edges) == a.backend.num_links


def test_move_gate_drops_unmoved_scans():
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    over = dict(fine_map_resolution=0.05, world_size=20.0, use_move_check=True)
    je = J.SlamEngine(J.load_config(SIM_YAML, **over), JLaser.from_array(d["laser"]),
                      synchronous_backend=True, fused_backend=False)
    te = T.SlamEngine(T.load_config(SIM_YAML, **over), TLaser.from_array(d["laser"]),
                      device="cpu")
    # every scan is fed twice: the repeat has not moved and must be dropped
    feed = [(d["ranges"][i // 2], d["odom"][i // 2], float(d["times"][i // 2]) + 0.01 * (i % 2))
            for i in range(12)]
    kj = [je.process(*f) for f in feed]
    kt = [te.process(*f) for f in feed]
    assert kj == kt and not all(kt)
    assert te.diag.scans_dropped_move == je.diag.scans_dropped_move > 0


def test_pub_map_grows_when_scan_leaves_it():
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    cfg = T.load_config(SIM_YAML, fine_map_resolution=0.05, world_size=6.0)
    with pytest.warns(RuntimeWarning):
        eng = T.SlamEngine(cfg, TLaser.from_array(d["laser"]), device="cpu")
        before = eng.fspec.pub_spec.height
        for i in range(3):
            eng.process(d["ranges"][i], d["odom"][i], float(d["times"][i]))
    after = eng.fspec.pub_spec
    assert after.height > before and eng.state.pub.hits.shape == (after.height, after.width)
    assert eng.backend.spec.pub_spec == after
    assert eng.store.pub_map_arrays()[0] == after


def test_device_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SlamEngine(T.load_config(SIM_YAML), TLaser.from_array(d["laser"]))


@pytest.mark.parametrize("kwargs,over", [
    (dict(synchronous_backend=False), {}),
    (dict(fused_backend=True), {}),
    (dict(pipelined_fetch=True), {}),
    ({}, dict(use_running_range_scan_match=True)),
    ({}, dict(use_odom_correct=True)),
    ({}, dict(match_map_window=8.0)),
])
def test_unsupported_modes_raise(kwargs, over):
    """Every engine mode and option that raised while it was not ported (the
    asynchronous back end, the fused step, the pipelined fetch, windowed
    match, de-distortion, rolling match-map window) now constructs and takes
    scans."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    cfg = T.load_config(SIM_YAML, fine_map_resolution=0.05, world_size=20.0, **over)
    laser = TLaser.from_array(d["laser"])
    if "use_odom_correct" in over:
        import dataclasses
        laser = dataclasses.replace(laser, scan_time=0.02)
    eng = T.SlamEngine(cfg, laser, device="cpu", **kwargs)
    for i in range(3):
        eng.process(d["ranges"][i], d["odom"][i], float(d["times"][i]))
    eng.finish()
    assert len(eng.store) >= 2 and np.isfinite(eng.trajectory_array()).all()
    assert eng.backend.graph.num_vertices == len(eng.store)
    if kwargs.get("synchronous_backend") is False:
        assert eng._backend_thread is None and eng.diag.backend_batches >= 1
    if kwargs.get("fused_backend"):              # the default, as in JAX
        default = inspect.signature(T.SlamEngine).parameters["fused_backend"].default
        assert eng._fused_backend and default is True
    if kwargs.get("pipelined_fetch"):
        assert eng.pipelined_fetch and not eng._inflight
        assert eng.diag.scans_processed == len(eng.store) == len(eng.trajectory)
    if "match_map_window" in over:
        fs = eng.fspec.fine_spec
        assert fs.width * fs.resolution <= 8.0 + 128 * fs.resolution


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing every module of the port brings in
    neither jax nor the JAX package (modules an interpreter start-up hook
    may have preloaded are not the port's doing and are left out)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import roborts_slam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "p.SlamEngine\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'roborts_slam_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'roborts_slam_tpu_torch.engine' in new and 'torch' in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
