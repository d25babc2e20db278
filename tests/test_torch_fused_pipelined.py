"""Port vs JAX package: the fused front-end+chain step (``fused_backend=True``,
the default in both packages) and the pipelined fetch (``pipelined_fetch``).
Inputs: ``tests/data/golden_icra.npz`` under ``configs/simulation.yaml`` at
the narrow size of ``test_torch_engine.py``, 40 scans out and the same 40
back with the link radius cut to 1 m (near chains, loop candidates and one
closure), and the pose graph's chain discovery on random graphs from a
seed.

Bars: chain discovery exactly as the JAX package's; fused against unfused in
the port 1e-5 (JAX's own bar, ``tests/test_engine_features.py:518-552``);
pipelined against blocking 1e-4 with identical pub maps (``:653-689``); the
port against the JAX package 2e-3 m / 2e-3 rad, the engine bar of
``test_torch_engine.py``, with its counted tie-flip outliers."""

import os

import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu_torch as T
from roborts_slam_tpu.backend.pose_graph import PoseGraph as JGraph
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.backend.pose_graph import PoseGraph as TGraph
from roborts_slam_tpu_torch.frontend.processor import FrontendSpec, frontend_step
from roborts_slam_tpu_torch.models.grid_map import CountMap, ProbMap
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser
from roborts_slam_tpu_torch.models.scan import ranges_to_packed
from roborts_slam_tpu_torch.ops.raster import stamp_scan, update_count_map
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0, link_scan_max_distance=1.0)
OUT_AND_BACK = list(range(40)) + list(range(39, -1, -1))
TIMES = [0.1 * k for k in range(len(OUT_AND_BACK))]
OUT = 40                      # scans on the way out (no chain, no closure yet)


# free runs over other stretches of the 120-scan log: start offsets of the
# out-and-back (the first is OUT_AND_BACK's); the tests take FREE_VARIANTS
VARIANTS = (0, 10, 20, 30, 40, 50, 60, 70)
FREE_VARIANTS = VARIANTS[:3]
UNCLOSED = dict(loop_match_min_response_fine=2.0)   # no loop verifies


def free_run(start: int, mode: str) -> dict:
    """A run of the port and of the JAX engine over the out-and-back from
    ``start``, both fused (``mode`` "fused": the ``out_and_back`` fixture's
    pair) or both pipelined with closures out of reach ("pipelined": the
    ``unclosed`` fixture's). {"out" / "end": (JAX's record, the port's)},
    at the end of the way out (the pipeline drained) and of the run."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    order = [start + i for i in OUT_AND_BACK]
    over = UNCLOSED if mode == "pipelined" else {}
    cfg = dict(OVER, **over)
    je = J.SlamEngine(J.load_config(SIM_YAML, **cfg), JLaser.from_array(d["laser"]),
                      synchronous_backend=True)
    te = T.SlamEngine(T.load_config(SIM_YAML, **cfg), TLaser.from_array(d["laser"]),
                      device="cpu")
    out = {}
    for eng in (je, te):
        eng.pipelined_fetch = mode == "pipelined"
        eng.pipeline_depth = 3
    for phase, ks in (("out", range(OUT)), ("end", range(OUT, len(OUT_AND_BACK)))):
        for eng in (je, te):
            _feed(eng, d, ks, order=order)
            if phase == "out":
                eng._drain_pipeline()
            else:
                eng.finish()
        out[phase] = (parity.run_record(je, TIMES), parity.run_record(te, TIMES))
    return out


@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _port(icra, pipelined=False, **kw):
    over = dict(OVER, **kw.pop("over", {}))
    eng = T.SlamEngine(T.load_config(SIM_YAML, **over), TLaser.from_array(icra["laser"]),
                       device="cpu", **kw)
    eng.pipelined_fetch = pipelined
    return eng


def _jax(icra, pipelined=False, **kw):
    eng = J.SlamEngine(J.load_config(SIM_YAML, **OVER), JLaser.from_array(icra["laser"]),
                       synchronous_backend=True, **kw)
    eng.pipelined_fetch = pipelined
    return eng


def _scans(icra, ks):
    """``L.lockstep``'s feed of the out-and-back's scans ``ks``."""
    return [("process", (icra["ranges"][OUT_AND_BACK[k]], icra["odom"][OUT_AND_BACK[k]],
                         TIMES[k])) for k in ks]


def _feed(eng, icra, ks, times=TIMES, order=OUT_AND_BACK):
    for k in ks:
        eng.process(icra["ranges"][order[k]], icra["odom"][order[k]], times[k])


def _edges(eng):
    return sorted((e.source, e.target) for e in eng.backend.graph.edges)


def _device_rows_are_the_host_rows(eng):
    n = len(eng.store)
    pts, msk, poses = eng.store.device_arrays()
    np.testing.assert_array_equal(pts[:n].numpy(), np.stack(eng.store._points))
    np.testing.assert_array_equal(msk[:n].numpy(), np.stack(eng.store._masks))
    np.testing.assert_array_equal(poses[:n].numpy(),
                                  eng.store.poses_array().astype(np.float32))


# ---- the pose graph's chain discovery for the next vertex ----

def _random_graphs(seed):
    """The same random graph in both packages: a chain of odometry edges
    along a wandering path and random extra links, barycenters on the path."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 60))
    steps = rng.normal(0.0, 0.25, (n, 2)).cumsum(0)
    bary = np.concatenate([steps, rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    graphs = (JGraph(1.0, 3), TGraph(1.0, 3))
    links = [(i - 1, i) for i in range(1, n)]
    links += [tuple(sorted(rng.choice(n, 2, replace=False))) for _ in range(n // 4)]
    for g in graphs:
        for _ in range(n):
            g.add_vertex()
        for a, b in links:
            g.add_edge(int(a), int(b), np.zeros(3), np.zeros(3), np.eye(3))
    return graphs, bary, rng


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_discovery_for_new_matches_jax(seed, k):
    """``find_near_chains_for_new`` and ``find_all_loop_candidates_for_new``
    with ``k`` hypothetical vertices (``k - 1`` in-flight scans, then the new
    one) find exactly the JAX package's chains, and leave the graph as it
    was."""
    (jg, tg), bary, rng = _random_graphs(seed)
    found = 0
    for _ in range(8):
        extra = bary[rng.integers(0, len(bary), k), :] + rng.normal(0, 0.3, (k, 3))
        rows = np.concatenate([bary, extra])
        near = tg.find_near_chains_for_new(rows, k=k)
        loop = tg.find_all_loop_candidates_for_new(rows, k=k)
        assert near == jg.find_near_chains_for_new(rows, k=k)
        assert loop == jg.find_all_loop_candidates_for_new(rows, k=k)
        found += len(near) + len(loop)
    assert found > 0
    assert tg.num_vertices == jg.num_vertices == len(bary)
    assert tg.adjacency == jg.adjacency


# ---- batch sizes ----

@pytest.mark.parametrize("profile", ["simulation", "real_robot", "default"])
def test_batch_buckets_match_jax_on_the_cpu(profile):
    """Off the card both packages plan with the same 6e9-byte budget and the
    same analytic model: the same largest chain batch, fused or not, and the
    same bucket to cut batches at."""
    laser = JLaser.from_array(np.load(os.path.join(REPO, "tests", "data",
                                                   "golden_icra.npz"))["laser"])
    if profile == "default":
        jcfg, tcfg = J.SlamConfig(), T.SlamConfig()
    else:
        path = os.path.join(REPO, "configs", f"{profile}.yaml")
        jcfg, tcfg = J.load_config(path), T.load_config(path)
    je = J.SlamEngine(jcfg, laser, world_size=20.0, fused_backend=False)
    te = T.SlamEngine(tcfg, TLaser.from_array(laser.to_array()), world_size=20.0,
                      device="cpu")
    jb, tb = je.backend, te.backend
    assert tb.device_memory_budget() == jb.device_memory_budget() == 6e9
    for fused in (False, True):
        lim = jb.max_parallel_chains(fused=fused)
        assert tb.max_parallel_chains(fused=fused) == lim
        assert tb.chain_step(fused=fused) == max(b for b in jb._BATCH_BUCKETS if b <= lim)
    assert tb._BATCH_BUCKETS == jb._BATCH_BUCKETS
    assert te._select_pipe_bucket() == je._select_pipe_bucket()


def test_chain_batches_are_padded_to_buckets(icra):
    """A batch of 3 chains is matched at the bucket of 4, and more chains
    than ``chain_step`` are cut at it; each chain's rows do not depend on
    the batch it was matched in."""
    eng = _port(icra, fused_backend=False)
    _feed(eng, icra, range(20))
    b = eng.backend
    chains = [[0, 1, 2], [3, 4, 5], [6, 7]]
    last = len(eng.store) - 1
    init = eng.store.poses[last].copy()
    seen = []
    orig = b._batch_on_device
    b._batch_on_device = lambda ids, *a: seen.append(ids.shape) or orig(ids, *a)
    three = b._match_chain_batch(chains, last, init)
    one = [b._match_chain_batch([c], last, init)[0] for c in chains]
    b.chain_step = lambda fused=False: 2
    cut = b._match_chain_batch(chains, last, init)
    K = eng.bspec.max_chain_scans
    assert seen == [(4, K), (1, K), (1, K), (1, K), (2, K), (1, K)]
    for rows in (one, cut):
        for (p, s, c), (p3, s3, c3) in zip(rows, three):
            np.testing.assert_allclose(p, p3, atol=1e-5)
            assert abs(s - s3) <= 1e-5


# ---- the device-gated map update and the device move gate ----

def test_gated_updates_keep_the_bits_or_equal_the_ungated(icra):
    """``update_count_map`` / ``stamp_scan`` under a false gate leave every
    bit of the map; under a true gate they equal the ungated update."""
    eng = _port(icra)
    _feed(eng, icra, range(5))
    pts, msk, _ = ranges_to_packed(icra["ranges"][6], eng.laser, eng.config.max_points)
    pts, msk = torch.as_tensor(pts), torch.as_tensor(msk)
    pose = eng.state.pose + torch.tensor([0.05, -0.03, 0.02])
    fs, ps = eng.fspec, eng.fspec.pub_spec
    for on in (False, True):
        gate = torch.tensor(on)
        pub = [CountMap(eng.state.pub.hits.clone(), eng.state.pub.passes.clone(),
                        eng.state.pub.offset) for _ in range(2)]
        fine = [ProbMap(eng.state.fine.probs.clone(), eng.state.fine.offset) for _ in range(2)]
        update_count_map(ps, pub[0], pts, msk, pose, torch.tensor(0.3), torch.tensor(0.7),
                         gate=gate)
        stamp_scan(fs.fine_spec, fine[0], pts, msk, pose, gate=gate)
        if on:
            update_count_map(ps, pub[1], pts, msk, pose, torch.tensor(0.3), torch.tensor(0.7))
            stamp_scan(fs.fine_spec, fine[1], pts, msk, pose)
            assert not torch.equal(pub[1].hits, eng.state.pub.hits)
        for a, b in ((pub[0].hits, pub[1].hits), (pub[0].passes, pub[1].passes),
                     (fine[0].probs, fine[1].probs)):
            assert torch.equal(a, b)


def test_device_move_gate_matches_jax(icra):
    """The step given ``cur_time`` gates on the device as the JAX step does:
    an unmoved scan inside the time threshold changes nothing but the
    penalty count, one past it passes, and the device-gated maps equal the
    host-gated ones; pose, gate and ``last_step_time`` within the front-end
    bar of ``test_torch_matchers_frontend.py``."""
    import jax
    import jax.numpy as jnp

    from roborts_slam_tpu.frontend import processor as jfp
    from roborts_slam_tpu_torch.convert import state_from_jax

    over = dict(OVER, use_move_check=True, move_distance_threshold=0.1)
    laser = JLaser.from_array(icra["laser"])
    jspec = jfp.FrontendSpec.from_config(J.load_config(SIM_YAML, **over), laser.range_max, 24.0)
    tspec = FrontendSpec.from_config(T.load_config(SIM_YAML, **over), laser.range_max, 24.0)
    jstate = jfp.init_frontend_state(jspec)
    jstep = jax.jit(jfp.frontend_step, static_argnames=("spec",))
    leaves = lambda s: {
        "pub_hits": s.pub.hits, "pub_passes": s.pub.passes, "pub_offset": s.pub.offset,
        "coarse_probs": s.coarse.probs, "coarse_offset": s.coarse.offset,
        "fine_probs": s.fine.probs, "fine_offset": s.fine.offset, "pose": s.pose,
        "last_map_update_pose": s.last_map_update_pose,
        "map_penalize_times": s.map_penalize_times, "scan_index": s.scan_index,
        "last_kept_odom": s.last_kept_odom, "last_step_time": s.last_step_time}
    tstate = state_from_jax({k: np.asarray(v) for k, v in leaves(jstate).items()}, "cpu")
    hstate = state_from_jax({k: np.asarray(v) for k, v in leaves(jstate).items()}, "cpu")
    # scans 0..5, then scan 5 again at 1.5 s (unmoved: gated) and at 5.55 s
    # (unmoved, but past the 5 s time threshold: kept), then scan 6
    feed = [(i, 0.1 * i) for i in range(6)] + [(5, 1.5), (5, 5.55), (6, 5.6)]
    gates = []
    for i, t in feed:
        pts, msk, nv = ranges_to_packed(icra["ranges"][i], laser, tspec.config.max_points)
        odom = icra["odom"][i].astype(np.float32)
        jstate, jinfo = jstep(jspec, jstate, jnp.asarray(pts), jnp.asarray(msk),
                              jnp.int32(nv), jnp.asarray(odom), jnp.float32(t))
        args = (torch.as_tensor(pts), torch.as_tensor(msk), nv, torch.as_tensor(odom),
                torch.tensor(t, dtype=torch.float32))
        tstate, tinfo = frontend_step(tspec, tstate, *args, device_gate=True)
        hstate, hinfo = frontend_step(tspec, hstate, *args)
        gates.append(bool(tinfo.map_updated))
        assert gates[-1] == bool(jinfo.map_updated) == bool(hinfo.summary[12] > 0.5)
        assert bool(tinfo.pose_accepted) == bool(jinfo.pose_accepted)
        np.testing.assert_allclose(tinfo.pose.numpy(), np.asarray(jinfo.pose), atol=2e-4)
        assert float(tstate.last_step_time) == float(jstate.last_step_time)
        assert int(tstate.map_penalize_times) == int(jstate.map_penalize_times)
        for a, b in ((tstate.pub.hits, hstate.pub.hits), (tstate.fine.probs, hstate.fine.probs),
                     (tstate.coarse.probs, hstate.coarse.probs)):
            assert torch.equal(a, b)
    assert gates[6] is False and gates[7] is True


# ---- the engine: fused ----

@pytest.fixture(scope="module")
def out_and_back(icra):
    """The out-and-back run through the port blocking unfused, fused (its
    device store started at 16 rows, so that it grows under fused appends)
    and pipelined, and through the JAX engine fused, fed in lockstep
    (``lockstep``: the port carried into its state before each scan); for
    the fused runs also the record at the end of the way out."""
    runs = {}
    for name, make, kw in (("unfused", _port, dict(fused_backend=False)),
                           ("fused", _port, {}), ("pipelined", _port, dict(pipelined=True)),
                           ("jax_fused", _jax, {})):
        eng = make(icra, **kw)
        if make is _port:
            eng.store._DEV_CAP_START = 16
        out, back = _scans(icra, range(OUT)), _scans(icra, range(OUT, len(OUT_AND_BACK)))
        if make is _jax:
            runs["lockstep"] = L.lockstep(eng, out, name="fused")
        else:
            _feed(eng, icra, range(OUT))
        if "fused" in name:
            runs[f"{name}_out"] = parity.run_record(eng, TIMES)
        if make is _jax:
            L.lockstep(eng, back + [("finish", ())], report=runs["lockstep"])
        else:
            _feed(eng, icra, range(OUT, len(OUT_AND_BACK)))
            eng.finish()
        runs[name] = eng
    return runs


def test_fused_matches_unfused(out_and_back):
    """JAX's bar for its own fused step: the same kept scans, graph and
    closures, trajectory within 1e-5, fewer separate chain batches; the
    device store rows, written by the fused appends across a capacity
    growth, equal the host rows."""
    u, f = out_and_back["unfused"], out_and_back["fused"]
    assert f.diag.fused_steps > 0 and f.backend.num_fused_hits > 0
    assert f.backend.num_chain_dispatches < u.backend.num_chain_dispatches
    assert len(f.store) == len(u.store) and f.store._dev_cap > 16
    assert (f.backend.num_links, f.backend.num_loop_closures) == \
        (u.backend.num_links, u.backend.num_loop_closures)
    assert _edges(f) == _edges(u)
    np.testing.assert_allclose(f.trajectory_array(), u.trajectory_array(), atol=1e-5)
    np.testing.assert_array_equal(f.get_pub_map(), u.get_pub_map())
    _device_rows_are_the_host_rows(f)


FORMS = ["lockstep"] + [f"free-{v}" for v in FREE_VARIANTS]


@pytest.mark.parametrize("form", FORMS)
def test_fused_matches_jax_fused(icra, out_and_back, form):
    """Port fused against JAX fused. ``lockstep``: every step of the
    out-and-back (fused steps, their chain rows, the closure and its
    solve) from JAX's carried state at the per-step bars (pose 1e-5 m /
    1e-5 rad, score, covariance, the same links, closure and solve, then
    the poses within 1e-3, map cells), at most 3 tie flips. ``free-0``
    (the ``out_and_back`` fixture's runs): the same fused steps, and fused
    hits equal but for a tie-flip outlier (a barycenter within 3e-3 m of
    the 1 m link radius after the closure: at most one here), and the bars
    of a whole run; ``free-<start>``: those bars on the out-and-back from
    that offset (closures and solves equal, kept within one scan, RMS gap
    to JAX within 5 mm, on the way out and at the end; the count of poses
    beyond 2e-3 m printed)."""
    if form == "lockstep":
        L.assert_lockstep(out_and_back["lockstep"])
        return
    start = int(form.split("-")[1])
    if start:
        runs = free_run(start, "fused")
    else:
        t, j = out_and_back["fused"], out_and_back["jax_fused"]
        assert t.diag.fused_steps == j.diag.fused_steps > 20
        assert abs(t.backend.num_fused_hits - j.backend.num_fused_hits) <= 1
        assert t.backend.num_fused_hits + t.backend.num_fused_misses == \
            j.backend.num_fused_hits + j.backend.num_fused_misses
        runs = {"out": (out_and_back["jax_fused_out"], out_and_back["fused_out"]),
                "end": (parity.run_record(j, TIMES), parity.run_record(t, TIMES))}
    for phase in ("out", "end"):
        L.assert_free(*runs[phase], f"fused {phase} {form}")


# ---- the engine: pipelined ----

def test_pipelined_matches_blocking(out_and_back):
    """JAX's bar for its pipelined fetch: the same kept count, links and
    closures, trajectory within 1e-4, identical pub maps; the device rows,
    written at the device cursor, equal the host rows. Here through the
    closure too: a scan with loop candidates is reconciled before the next
    dispatch (the JAX engine dispatches on and parts at the closure, see
    ``test_jax_pipeline_parts_at_a_closure``)."""
    b, p = out_and_back["fused"], out_and_back["pipelined"]
    assert not p._inflight and p.diag.fused_steps > 0
    assert len(p.store) == len(b.store)
    assert (p.backend.num_links, p.backend.num_loop_closures) == \
        (b.backend.num_links, b.backend.num_loop_closures) and p.backend.num_loop_closures >= 1
    np.testing.assert_allclose(p.trajectory_array(), b.trajectory_array(), atol=1e-4)
    np.testing.assert_array_equal(p.get_pub_map(), b.get_pub_map())
    assert p.diag.scans_processed == len(p.store) == p.backend.graph.num_vertices
    assert (p.diag.scans_dropped_move, p.diag.scans_dropped_gate) == \
        (b.diag.scans_dropped_move, b.diag.scans_dropped_gate)
    _device_rows_are_the_host_rows(p)


@pytest.fixture(scope="module")
def unclosed(icra):
    """The out-and-back with the fine loop verification out of reach
    (``loop_match_min_response_fine`` 2): near chains and loop candidates on
    the way back ride pipelined fused steps, and no loop closes, pipelined
    through both packages."""
    over = dict(OVER, loop_match_min_response_fine=2.0)
    laser = icra["laser"]
    runs = {}
    for name, eng in (
            ("port", T.SlamEngine(T.load_config(SIM_YAML, **over), TLaser.from_array(laser),
                                  device="cpu")),
            ("jax", J.SlamEngine(J.load_config(SIM_YAML, **over), JLaser.from_array(laser)))):
        eng.pipelined_fetch = True
        eng.pipeline_depth = 3
        _feed(eng, icra, range(OUT))
        eng._drain_pipeline()
        runs[f"{name}_out"] = parity.run_record(eng, TIMES)
        _feed(eng, icra, range(OUT, len(OUT_AND_BACK)))
        eng.finish()
        runs[name] = eng
    return runs


@pytest.mark.parametrize("form", FORMS)
def test_pipelined_matches_jax_pipelined(icra, unclosed, form):
    """Port pipelined against JAX pipelined where no loop closes.
    ``lockstep``: the pipeline's blocking form (a pipelined step cannot be
    carried one scan at a time; the pipeline stays held against the port's
    own blocking engine in ``test_pipelined_matches_blocking``), every step
    from JAX's carried state at the per-step bars, at most 3 tie flips.
    ``free-0`` (the ``unclosed`` fixture's pipelined runs): no closure, the
    same fused steps and links, and the bars of a whole run;
    ``free-<start>``: those bars on the out-and-back from that offset, on
    the way out and at the end."""
    if form == "lockstep":
        je = J.SlamEngine(J.load_config(SIM_YAML, **dict(OVER, **UNCLOSED)),
                          JLaser.from_array(icra["laser"]), synchronous_backend=True)
        scans = _scans(icra, range(len(OUT_AND_BACK))) + [("finish", ())]
        L.assert_lockstep(L.lockstep(je, scans, name="pipelined, blocking form"))
        return
    start = int(form.split("-")[1])
    if start:
        runs = free_run(start, "pipelined")
    else:
        t, j = unclosed["port"], unclosed["jax"]
        assert t.backend.num_loop_closures == j.backend.num_loop_closures == 0
        assert t.diag.fused_steps == j.diag.fused_steps > 0
        assert t.backend.num_links == j.backend.num_links
        runs = {"out": (unclosed["jax_out"], unclosed["port_out"]),
                "end": (parity.run_record(j, TIMES), parity.run_record(t, TIMES))}
    for phase in ("out", "end"):
        L.assert_free(*runs[phase], f"pipelined {phase} {form}")


def test_jax_pipeline_parts_at_a_closure(icra, out_and_back):
    """The reference-side behaviour the port departs from: the JAX pipelined
    engine matches the scans in flight at a closure against the maps before
    the correction, and ends with other links than its blocking engine;
    the port's pipelined run equals its blocking run (above)."""
    je = _jax(icra, pipelined=True)
    _feed(je, icra, range(len(OUT_AND_BACK)))
    je.finish()
    jb = out_and_back["jax_fused"]
    assert je.backend.num_loop_closures == jb.backend.num_loop_closures >= 1
    assert je.backend.num_links != jb.backend.num_links
    assert out_and_back["pipelined"].backend.num_links == jb.backend.num_links


def test_pipelined_pose_mirror_refreshes_after_correction(icra):
    """(JAX ``test_engine_features.py:717-746``) A correction marks the
    device pose mirror stale; the next pipelined dispatch rebuilds it before
    any chain gather reads it."""
    eng = _port(icra, pipelined=True)
    eng.pipeline_depth = 2
    _feed(eng, icra, range(30))
    eng._drain_pipeline()
    n = len(eng.store)
    shift = np.array([0.3, -0.15, 0.05])
    for sid in range(n):          # what a correction does to the stored poses
        eng.store.set_pose(sid, np.asarray(eng.store.poses[sid]) + shift)
    assert eng.store._dev_poses_stale
    _feed(eng, icra, range(30, 34))
    np.testing.assert_allclose(eng.store._dev_poses[:n].numpy(),
                               eng.store.poses_array()[:n].astype(np.float32), atol=1e-5)


def test_pipelined_snapshot_drains_keep_commit_order(icra):
    """(JAX ``:749-777``) Snapshot events drain the pipeline in the middle of
    a reconcile; a younger scan never commits before the current one: graph
    vertices, store ids and device rows agree scan for scan."""
    eng = _port(icra, pipelined=True)
    snaps = []
    eng.map_snapshot_every = 2
    eng.on_map_snapshot = lambda n, grid: snaps.append(n)
    _feed(eng, icra, range(len(OUT_AND_BACK)))
    eng.finish()
    n = len(eng.store)
    assert len(snaps) == n // 2          # once for each even count committed
    assert eng.backend.graph.num_vertices == n and eng.backend.num_loop_closures >= 1
    _device_rows_are_the_host_rows(eng)


@pytest.mark.parametrize("offset", [0.0, 1.7564e9])
def test_pipelined_epoch_timestamps_keep_time_escape(icra, offset):
    """(JAX ``:780-810``) Under UNIX-epoch stamps the device move gate still
    keeps a parked robot's scan every ``move_time_threshold`` seconds:
    device times count from the first stamp, taken in float64 on the host.
    The parked scans kept are those of the blocking engine."""
    over = dict(use_move_check=True, move_distance_threshold=0.1)
    dt = 5.0 + 0.5                                   # past the 5 s threshold
    kept = {}
    for pipelined in (False, True):
        eng = _port(icra, pipelined=pipelined, over=over)
        eng.pipeline_depth = 2
        for i in range(20):
            eng.process(icra["ranges"][i], icra["odom"][i], float(icra["times"][i]) + offset)
        eng._drain_pipeline()
        before = len(eng.store)
        t0 = float(icra["times"][19]) + offset
        for k in range(1, 5):                        # parked: same scan and odometry
            eng.process(icra["ranges"][19], icra["odom"][19], t0 + k * dt)
        eng.finish()
        kept[pipelined] = len(eng.store) - before
    assert kept[True] == kept[False] >= 1, kept


def test_async_fused_carries_prematched(icra):
    """(JAX ``:618-650``) The asynchronous engine rides the fused step too:
    the worker takes the chain rows from its queue, and separate batches
    run only on misses and after corrections."""
    import time

    eng = _port(icra, synchronous_backend=False)
    for k in range(len(OUT_AND_BACK)):
        _feed(eng, icra, [k])
        for _ in range(400):          # let the worker catch up, as the JAX test does
            if eng._backend_queue.empty():
                break
            time.sleep(0.005)
    eng.finish()
    b = eng.backend
    assert eng.diag.fused_steps > 0 and b.num_fused_hits > 0
    assert b.num_chain_dispatches <= b.num_fused_misses + b.num_solves + 4, \
        (b.num_chain_dispatches, b.num_fused_misses)
    assert b.num_links >= 1 and np.isfinite(eng.trajectory_array()).all()
    assert len(eng.store) == b.graph.num_vertices


@pytest.mark.parametrize("pipelined", [False, True])
def test_warm_backend_warms_the_fused_steps_without_side_effects(icra, pipelined):
    """``warm_backend`` runs the fused step at each bucket (the pipelined
    step at the pipeline's bucket) on a copy of the state: a run continued
    after warming equals the unwarmed run bit for bit."""
    plain, warmed = (_port(icra, pipelined=pipelined) for _ in range(2))
    for eng in (plain, warmed):
        _feed(eng, icra, range(12))
    warmed.warm_backend(match_buckets=(1, 2, 4))
    for eng in (plain, warmed):
        _feed(eng, icra, range(12, 60))
        eng.finish()
    assert plain.diag.fused_steps > 0
    np.testing.assert_array_equal(plain.trajectory_array(), warmed.trajectory_array())
    np.testing.assert_array_equal(plain.get_pub_map(), warmed.get_pub_map())
    assert _edges(plain) == _edges(warmed)


def test_pipelined_matches_blocking_under_the_real_robot_profile(tmp_path):
    """Under a narrowed ``configs/real_robot.yaml`` (4 m rolling match-map
    window, de-distortion, move gates; 640 points, 1.5 m link radius) on
    1.35 laps round the block of a simulated room: scans that may recenter
    or close a loop are reconciled before the next dispatch, and the
    pipelined run equals the blocking one — recenters, kept scans, graph,
    closure, trajectory (1e-4) and pub map. (The JAX engine dispatches on
    past both; its own bar for the pipeline is this one.)"""
    import yaml

    from roborts_slam_tpu_torch.io.pgm import GroundTruthMap
    from roborts_slam_tpu_torch.io.simulate import path_to_trajectory, simulate_log

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
    corners = np.array([[0, -1.3], [2.6, -1.3], [2.6, 1.3], [-2.6, 1.3],
                        [-2.6, -1.3], [0, -1.3]])
    lap = np.concatenate([np.linspace(corners[i], corners[i + 1], 60, endpoint=False)
                          for i in range(5)])
    path = np.concatenate([lap, lap[:int(len(lap) * 0.35)]])
    log = simulate_log(gt, laser, trajectory=path_to_trajectory(path, 0.8, 5.0),
                       range_noise=0.005, odom_error=(0.05, 0.05, 0.08), seed=4)
    with open(os.path.join(REPO, "configs", "real_robot.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(max_points=640, match_map_window=4.0, link_scan_max_distance=1.5)
    path = str(tmp_path / "rr.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    runs = {}
    for pipelined in (False, True):
        eng = T.SlamEngine(T.load_config(path), laser, world_size=14.0, device="cpu")
        eng.pipelined_fetch = pipelined
        for i in range(len(log)):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        eng.finish()
        runs[pipelined] = eng
    b, p = runs[False], runs[True]
    assert b.diag.recenters >= 5 and b.backend.num_loop_closures >= 1
    assert p.diag.fused_steps == b.diag.fused_steps > 0
    assert (p.diag.recenters, p.diag.scans_dedistorted, p.backend.num_loop_closures) == \
        (b.diag.recenters, b.diag.scans_dedistorted, b.backend.num_loop_closures)
    # drops at the move gate (host or device) and at the score or map-update
    # gate are counted as the blocking engine counts them
    assert (p.diag.scans_dropped_move, p.diag.scans_dropped_gate) == \
        (b.diag.scans_dropped_move, b.diag.scans_dropped_gate)
    assert b.diag.scans_dropped_gate > 0
    np.testing.assert_allclose(p.trajectory_array(), b.trajectory_array(), atol=1e-4)
    np.testing.assert_array_equal(p.get_pub_map(), b.get_pub_map())
    assert _edges(p) == _edges(b)
    _device_rows_are_the_host_rows(p)
