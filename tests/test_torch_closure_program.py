"""Port vs JAX package: the loop closure as the JAX package compiles it. The
pose graph padded to JAX's buckets (``as_solver_data``) and solved padded;
the masked LM loop against JAX's two ``while_loop``s run as host loops, bit
for bit, with the CG steps they take; the correction rebuild on the store
padded to JAX's bucket (``all_arrays``) against JAX's ``_rebuild_all_maps``
and against a per-scan loop over the exact scans; the solve programs' keys;
the correction rebuild, eager from the exact rows into the state's planes,
across a pub growth and a mirror doubling; the pub-only clip rebuild on the
exact rows; ``warm_backend``'s buckets. Inputs are made
with numpy from a seed (graphs round a circle, scans of
``tests/data/golden_icra.npz``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu.backend.spa as jspa
import roborts_slam_tpu.engine as jeng
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.backend.spa as tspa
import roborts_slam_tpu_torch.engine as teng
import roborts_slam_tpu_torch.models.grid_map as tgm
from roborts_slam_tpu.backend.pose_graph import PoseGraph as JGraph
from roborts_slam_tpu.frontend.processor import FrontendSpec as JSpec
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu.models.scan import ranges_to_packed
from roborts_slam_tpu_torch.backend.pose_graph import PoseGraph as TGraph
from roborts_slam_tpu_torch.frontend.processor import FrontendSpec as TSpec
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser
import roborts_slam_tpu_torch.ops.raster as traster
from roborts_slam_tpu_torch.ops.raster import scan_mark_image, stamp_scan_batch
from roborts_slam_tpu_torch.utils.geometry import normalize_angle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0)


def _graphs(n, e, seed, noise=0.01, init_noise=0.05, line=False):
    """The same graph in both packages: ``n`` nodes, the odometry chain and
    random loop edges up to ``e`` edges, each measured between noisy copies
    of the ground truth (a circle; ``line``: integer x, yaw 0, exact
    measurements), and the initial poses (ground truth plus noise, node 0
    exact)."""
    rng = np.random.default_rng(seed)
    if line:
        gt = np.stack([np.arange(n, dtype=np.float64), np.zeros(n), np.zeros(n)], -1)
    else:
        t = np.linspace(0, 2 * np.pi, n, endpoint=False)
        gt = np.stack([5 * np.cos(t), 5 * np.sin(t), np.arctan2(np.cos(t), -np.sin(t))], -1)
    cov = np.diag([1e-3, 1e-3, 1e-4])
    pairs = [(i, i + 1) for i in range(n - 1)]
    seen = set(pairs)
    while len(pairs) < e:
        i, j = sorted(int(v) for v in rng.choice(n, 2, replace=False))
        if j - i > 1 and (i, j) not in seen:
            seen.add((i, j))
            pairs.append((i, j))
    meas = [(gt[i] + rng.normal(0, noise, 3) * [1, 1, 0.3],
             gt[j] + rng.normal(0, noise, 3) * [1, 1, 0.3]) for i, j in pairs]
    graphs = JGraph(3.0, 3), TGraph(3.0, 3)
    for g in graphs:
        for _ in range(n):
            g.add_vertex()
        for (i, j), (a, b) in zip(pairs, meas):
            assert g.add_edge(i, j, a, b, cov)
    init = gt + rng.normal(0, init_noise, gt.shape) * [1, 1, 0.3]
    init[0] = gt[0]
    return (*graphs, init)


# ---- the pose graph padded to JAX's buckets ----

BUCKET_EDGES = [(63, 62), (63, 64), (64, 63), (64, 65), (65, 64), (65, 129),
                (300, 299), (300, 513)]


@pytest.mark.parametrize("n,e", BUCKET_EDGES)
def test_padded_solver_data_equals_jax(n, e):
    """Nodes and edges padded to 64·2^k on either side of a bucket's edge:
    every array, padding and masks included, equals JAX's."""
    jg, tg, init = _graphs(n, e, seed=n + e)
    jd, td = jg.as_solver_data(init), tg.as_solver_data(init, "cpu")
    want = lambda c: 64 * 2 ** max(0, int(np.ceil(np.log2(c / 64))))
    assert td.poses.shape == (want(n), 3) and td.edge_ij.shape == (want(e), 2)
    for name in tspa.PoseGraphData._fields:
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)).astype(
                                          getattr(td, name).numpy().dtype), err_msg=name)


@pytest.mark.parametrize("n,e,seed", [(40, 45, 0), (100, 140, 2)])
def test_padded_solve_matches_jax(n, e, seed):
    """The port's padded solve against JAX's ``solve_pose_graph`` on JAX's
    padded data, at ``test_torch_spa.py``'s bar (1e-4 m); the LM iteration
    counts printed."""
    jg, tg, init = _graphs(n, e, seed)
    jp, jc, jit_ = jspa.solve_pose_graph(jg.as_solver_data(init))
    tp, tc, tit = tspa.solve_pose_graph(tg.as_solver_data(init, "cpu"))
    print(f"lm iterations: port {int(tit)} jax {int(jit_)}")
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp[:n, :2], jp[:n, :2], atol=1e-4)
    d = np.arctan2(np.sin(tp[:n, 2] - jp[:n, 2]), np.cos(tp[:n, 2] - jp[:n, 2]))
    assert np.abs(d).max() < 1e-4
    assert abs(float(tc) - float(jc)) <= 1e-4 * abs(float(jc)) + 1e-6
    td = tg.as_solver_data(init, "cpu")
    assert float(tc) < 0.1 * float(tspa.graph_cost(td.poses, td))


def _while_solve(data, max_iters=50, cg_iters=100, tol=1e-6):
    """JAX's ``lm_solve`` and ``_pcg`` ``while_loop``s as host loops, each
    test read on the host, over the port's own products: the state where
    they exit (poses, cost, damping, LM iterations, converged) and the CG
    steps they take."""
    gauge = tspa._gauge_mask(data)
    poses, lam = data.poses, torch.full((), 1e-4)
    cost = tspa.graph_cost(poses, data)
    it = cg = 0
    done = False
    while it < max_iters and not done:
        lin = tspa._linearize(poses, data, gauge)
        g = tspa._gradient(lin, poses, data)
        b = -g
        pinv, _ = torch.linalg.inv_ex(tspa._block_diag(lin, data, lam))

        def precond(v):
            return torch.einsum("nij,nj->ni", pinv, v) * gauge

        x, r = torch.zeros_like(b), b
        z = precond(r)
        p, rz = z, torch.sum(r * z)
        bnorm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12)
        k = 0
        while k < cg_iters and bool(torch.sqrt(torch.sum(r * r)) > tol * bnorm):
            hp = tspa._hvp(lin, data, p) + lam * (p * gauge)
            alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
            x = x + alpha * p
            r_new = r - alpha * hp
            z = precond(r_new)
            rz_new = torch.sum(r_new * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p, r, rz = z + beta * p, r_new, rz_new
            k += 1
        cg += k
        new_poses = poses + x
        new_poses = torch.cat([new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
        new_cost = tspa.graph_cost(new_poses, data)
        improved = bool(new_cost < cost)
        done = (improved and bool((cost - new_cost) < 1e-7 * (cost + 1e-12))) or bool(
            torch.sqrt(torch.sum(g * g)) < 1e-10)
        if improved:
            poses, cost, lam = new_poses, new_cost, torch.clamp(lam * 0.33, min=1e-8)
        else:
            lam = lam * 10.0
        it += 1
    return poses, cost, lam, it, done, cg


WHILE_CASES = [dict(n=40, e=45, seed=0), dict(n=130, e=150, seed=5, noise=0.005),
               dict(n=30, e=29, seed=1, noise=0.0, init_noise=0.0, line=True)]


@pytest.mark.parametrize("case", WHILE_CASES, ids=["ring40", "ring130", "converged"])
def test_masked_loop_equals_while_loops(case):
    """The masked loop that a solve program replays (every one of 50 × 100
    steps computed, those after a test fails discarded) against JAX's
    ``while_loop``s run as host loops: poses, cost, damping, LM iterations
    and convergence bit for bit, and the CG steps it counts are those the
    while loops take, below ``it × cg_iters``. The last case starts at its
    optimum (exact measurements): a zero gradient, one iteration, no CG
    step."""
    _, tg, init = _graphs(**case)
    data = tg.as_solver_data(init, "cpu")
    got = tspa._masked_solve(data, 50, 100)
    poses, cost, lam, it, done, cg = _while_solve(data)
    assert torch.equal(got.poses, poses) and torch.equal(got.cost, cost)
    assert torch.equal(got.lam, lam)
    assert (int(got.it), bool(got.done), int(got.cg)) == (it, done, cg)
    print(f"lm iterations {it}, cg steps {cg}")
    if case.get("line"):
        assert it == 1 and done and cg == 0
    else:
        assert 0 < cg < it * 100
    packed = tspa._packed(got)
    p, c, i = tspa._unpacked(packed)
    assert torch.equal(p, got.poses) and torch.equal(c, got.cost)
    assert int(i) == it and int(packed[-1]) == cg


def test_solve_programs_keyed_by_bucket():
    """One program per (device, node bucket, edge bucket, budgets, sum
    mode): two graphs in one bucket share it, another bucket or budget has
    its own (made, not run: a program runs on the card only)."""
    a = _graphs(40, 45, 0)[1].as_solver_data(np.zeros((40, 3)), "cpu")
    b = _graphs(60, 63, 1)[1].as_solver_data(np.zeros((60, 3)), "cpu")
    c = _graphs(70, 75, 2)[1].as_solver_data(np.zeros((70, 3)), "cpu")
    pa = tspa.solve_program(a)
    assert tspa.solve_program(b) is pa and pa.name == "solve_64x64"
    assert tspa.solve_program(c).name == "solve_128x128"
    assert tspa.solve_program(a, 20, 100) is not pa
    assert tspa.closure_path("cpu") == "eager: cpu tensors"
    assert tspa.program_key(a) == ("cpu", 64, 64, 50, 100, False)


# ---- the correction rebuild on the store padded to JAX's bucket ----

@pytest.fixture(scope="module")
def stores():
    """The first 70 scans of the icra log in a JAX and a port store at
    their odometry poses, and both packages' specs of the narrowed
    simulation profile."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    jcfg, tcfg = J.load_config(SIM_YAML, **OVER), T.load_config(SIM_YAML, **OVER)
    jl, tl = JLaser.from_array(d["laser"]), TLaser.from_array(d["laser"])
    js, ts = jeng.ScanStore(jcfg.max_points), teng.ScanStore(tcfg.max_points, "cpu")
    for i in range(70):
        pts, msk, nv = ranges_to_packed(d["ranges"][i], jl, jcfg.max_points)
        pose = np.asarray(d["odom"][i], np.float64)
        for s in (js, ts):
            s.add(np.asarray(pts), np.asarray(msk), int(nv), pose, pose, 0.1 * i)
    return (jcfg, JSpec.from_config(jcfg, jl.range_max, OVER["world_size"]), js,
            tcfg, TSpec.from_config(tcfg, tl.range_max, OVER["world_size"]), ts)


def _offsets(spec):
    return np.array([spec.width, spec.height], np.float32) * spec.resolution / 2


def _port_maps(fs):
    return (tgm.make_count_map(fs.pub_spec, _offsets(fs.pub_spec), "cpu"),
            tgm.make_prob_map(fs.coarse_spec, _offsets(fs.coarse_spec), "cpu"),
            tgm.make_prob_map(fs.fine_spec, _offsets(fs.fine_spec), "cpu"))


def _factors(cfg):
    return (cfg.map_update_free_factor, cfg.map_update_occu_factor,
            int(cfg.map_min_passthrough), bool(cfg.coarse_map_use_blur),
            bool(cfg.fine_map_use_blur))


def test_padded_rebuild_matches_jax(stores):
    """The port's rebuild of every map on its store padded to JAX's bucket
    (70 scans in 128 slots) against JAX's ``_rebuild_all_maps`` on JAX's
    padded ``all_arrays()``: pub counts exact, coarse and fine within 1e-6."""
    jcfg, jfs, js, tcfg, tfs, ts = stores
    jarr, tarr = js.all_arrays(), ts.all_arrays()
    assert tarr[0].shape[0] == jarr[0].shape[0] == 128
    np.testing.assert_array_equal(tarr[3].numpy(), np.asarray(jarr[3]))
    free, occu, extra, cb, fb = _factors(jcfg)
    jpub, jco, jfi = jeng._rebuild_all_maps(
        jfs.pub_spec, jfs.coarse_spec, jfs.fine_spec,
        *(jnp.asarray(_offsets(s)) for s in (jfs.pub_spec, jfs.coarse_spec, jfs.fine_spec)),
        *jarr, jnp.float32(free), jnp.float32(occu), extra, cb, fb)
    pub, coarse, fine = _port_maps(tfs)
    teng._rebuild_all_maps(tfs.pub_spec, tfs.coarse_spec, tfs.fine_spec, pub, coarse, fine,
                           *tarr, *_factors(tcfg))
    np.testing.assert_array_equal(pub.hits.numpy(), np.asarray(jpub.hits))
    np.testing.assert_array_equal(pub.passes.numpy(), np.asarray(jpub.passes))
    assert pub.hits.sum() > 0
    np.testing.assert_allclose(coarse.probs.numpy(), np.asarray(jco.probs), atol=1e-6)
    np.testing.assert_allclose(fine.probs.numpy(), np.asarray(jfi.probs), atol=1e-6)


def _per_scan_pub(spec, offset, pts, msk, poses, free, occu, extra):
    """The pub rebuild as a loop over the exact scans, each carved alone and
    its counts added by 0/1 planes times the increments (the port's rebuild
    before the padded one), with scan 0 re-applied ``extra`` times."""
    out = tgm.CountMap(torch.zeros((spec.height, spec.width)),
                       torch.zeros((spec.height, spec.width)), offset)
    for i in [*range(pts.shape[0]), *[0] * extra]:
        mark = scan_mark_image(spec, offset, pts[i], msk[i], poses[i])
        out.hits.add_((mark == 2).to(torch.float32) * (1.0 + occu))
        out.passes.add_((mark > 0).to(torch.float32) * (1.0 + free))
    return out


def test_padded_rebuild_equals_unpadded_loop(stores):
    """The padded rebuild against a per-scan loop over the exact stored
    scans (``_per_scan_pub``; the match maps stamped from the exact rows):
    every map bit for bit (a masked slot adds zeros and stamps nothing)."""
    *_, tcfg, tfs, ts = stores
    pts, msk, poses, valid = ts.all_arrays()
    n = len(ts)
    pub, coarse, fine = _port_maps(tfs)
    teng._rebuild_all_maps(tfs.pub_spec, tfs.coarse_spec, tfs.fine_spec, pub, coarse, fine,
                           pts, msk, poses, valid, *_factors(tcfg))
    free, occu, extra, cb, fb = _factors(tcfg)
    ones = torch.ones((n,), dtype=torch.bool)
    want = _per_scan_pub(tfs.pub_spec, torch.as_tensor(_offsets(tfs.pub_spec)),
                         pts[:n], msk[:n], poses[:n], free, occu, extra)
    assert torch.equal(pub.hits, want.hits) and torch.equal(pub.passes, want.passes)
    for spec, got, blur in ((tfs.coarse_spec, coarse, cb), (tfs.fine_spec, fine, fb)):
        ref = stamp_scan_batch(spec, tgm.make_prob_map(spec, _offsets(spec), "cpu"),
                               pts[:n], msk[:n], poses[:n], ones, use_blur=blur)
        assert torch.equal(got.probs, ref.probs)


# ---- the engine's programs ----

@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _engine(icra, k=12):
    eng = T.SlamEngine(T.load_config(SIM_YAML, **OVER), TLaser.from_array(icra["laser"]),
                       device="cpu")
    for i in range(k):
        eng.process(icra["ranges"][i], icra["odom"][i], float(icra["times"][i]))
    return eng


def test_rebuild_after_growth_and_doubling_equals_exact_rows(icra):
    """A correction's rebuild after a pub-map growth and after a mirror
    doubling writes the maps that ``_rebuild_all_maps`` makes from the
    exact stored rows, bit for bit, into the state's planes (the grown pub
    map's new ones)."""
    eng = _engine(icra)
    assert eng.diag.closure_path == "eager: cpu tensors"
    with eng._state_lock:
        for event in ("pub_growth", "mirror_doubling"):
            if event == "pub_growth":
                eng._grow_pub_to(eng.fspec.pub_spec.width + 64, eng.fspec.pub_spec.height,
                                 64, 0)
            else:
                eng.store.device_arrays(reserve=eng.store._dev_cap)
            held = [t.data_ptr() for t in _live_planes(eng)]
            eng._rebuild_maps()
            assert [t.data_ptr() for t in _live_planes(eng)] == held
            for a, b in zip(_planes(eng), _eager_planes(eng)):
                assert torch.equal(a, b)
    assert eng.store._dev_cap == 2 * eng.store._DEV_CAP_START


def test_warm_backend_buckets_reach_the_programs(icra, monkeypatch):
    """``warm_backend(solver_buckets, rebuild_buckets)``: a solve of the live
    graph padded to each solver bucket it has not outgrown (nodes ``bn``,
    edges ``bn`` and ``2·bn``, as JAX warms them) and one eager rebuild of
    the live rows padded to each rebuild bucket that holds the store and
    that its mirror holds; the maps are restored after."""
    eng = _engine(icra)
    g = eng.backend.graph
    seen, rebuilt = [], []
    pack = TGraph.as_solver_data
    rebuild_all = T.SlamEngine._rebuild_all

    def spy(self, poses, device, pad_n=None, pad_e=None):
        seen.append((pad_n, pad_e))
        return pack(self, poses, device, pad_n, pad_e)

    def spy_rebuild(self, pts, msk, poses, valid):
        rebuilt.append((pts.shape[0], int(valid.sum())))
        return rebuild_all(self, pts, msk, poses, valid)

    monkeypatch.setattr(TGraph, "as_solver_data", spy)
    monkeypatch.setattr(T.SlamEngine, "_rebuild_all", spy_rebuild)
    before = _planes(eng)
    eng.warm_backend(solver_buckets=(64, 128), match_buckets=(1,),
                     rebuild_buckets=(8, 64, 128, 512))
    want = [(bn, be) for bn in (64, 128) for be in (bn, 2 * bn)
            if bn >= g.num_vertices and be >= len(g.edges)]
    assert seen == want and len(want) == 4
    n = len(eng.store)
    assert rebuilt == [(64, n), (128, n)]                  # 8 too small, 512 past the mirror
    for a, b in zip(_planes(eng), before):
        assert torch.equal(a, b)
    assert eng.backend.num_solves == 0


def _live_planes(eng):
    st = eng.state
    return [st.pub.hits, st.pub.passes, st.coarse.probs, st.fine.probs]


def _planes(eng):
    return [t.clone() for t in _live_planes(eng)]


def _eager_planes(eng):
    """Every map rebuilt by ``_rebuild_all_maps`` from the exact stored rows
    into fresh planes."""
    st, fs = eng.state, eng.fspec
    pub, coarse, fine = (tgm.CountMap(torch.zeros_like(st.pub.hits),
                                      torch.zeros_like(st.pub.passes), st.pub.offset),
                         tgm.ProbMap(torch.zeros_like(st.coarse.probs), st.coarse.offset),
                         tgm.ProbMap(torch.zeros_like(st.fine.probs), st.fine.offset))
    teng._rebuild_all_maps(fs.pub_spec, fs.coarse_spec, fs.fine_spec, pub, coarse, fine,
                           *eng.store.all_arrays(len(eng.store)), *_factors(eng.config))
    return [pub.hits, pub.passes, coarse.probs, fine.probs]


def test_first_correction_rebuilds_eagerly(icra, monkeypatch):
    """Every correction, the first and those after it, across a pub growth,
    rebuilds eagerly from the exact rows into the state's planes (the grown
    pub map's new ones), leaves the maps that ``_rebuild_all_maps`` makes
    from those rows, bit for bit, and captures nothing."""
    eng = _engine(icra)
    assert len(eng.store) < 64
    rows = []
    rebuild_all = T.SlamEngine._rebuild_all

    def spy_rebuild(self, pts, msk, poses, valid):
        rows.append((pts.shape[0], bool(valid.all())))
        return rebuild_all(self, pts, msk, poses, valid)

    monkeypatch.setattr(T.SlamEngine, "_rebuild_all", spy_rebuild)
    captures = (dict(eng.diag.captures_by_key), eng.diag.closure_capture_s)
    with eng._state_lock:
        for k in range(5):
            if k == 3:
                eng._grow_pub_to(eng.fspec.pub_spec.width + 64, eng.fspec.pub_spec.height,
                                 64, 0)
            held = [t.data_ptr() for t in _live_planes(eng)]
            eng._rebuild_maps()
            assert [t.data_ptr() for t in _live_planes(eng)] == held
            for a, b in zip(_planes(eng), _eager_planes(eng)):
                assert torch.equal(a, b)
    assert rows == [(len(eng.store), True)] * 5
    assert (eng.diag.captures_by_key, eng.diag.closure_capture_s) == captures
    assert not any(key.startswith("rebuild") for key in eng.diag.replays_by_key)


def test_pub_clip_rebuild_carves_exact_rows(icra, monkeypatch):
    """The pub-only clip rebuild (``_rebuild_pub``) carves the stored scans
    and the re-applications of scan 0, none of a bucket's padding slots:
    the rebuild's one call takes the exact rows, every one valid, and scan
    0's cells ``map_min_passthrough`` more times."""
    eng = _engine(icra)
    calls = []
    rebuild = traster.rebuild_counts

    def counted(start, end, beam_mask, slot_valid, *a, **kw):
        calls.append((start.shape[0], bool(slot_valid.all()), a[4]))
        return rebuild(start, end, beam_mask, slot_valid, *a, **kw)

    monkeypatch.setattr(traster, "rebuild_counts", counted)
    with eng._state_lock:
        eng._rebuild_pub()
    extra = int(eng.config.map_min_passthrough)
    assert calls == [(len(eng.store), True, extra)]
    assert len(eng.store) + extra < 64
