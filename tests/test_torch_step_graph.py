"""The per-scan step as one program (``roborts_slam_tpu_torch/step_graph.py``),
on the CPU at small sizes: what the card captures into a CUDA graph must read
nothing on the host, take every value of a scan (``n_valid`` included) as a
device input, write its state in place, and be made anew where a buffer it
holds was replaced. On CPU tensors the programs run eagerly; the capture and
its replays run on the card (``chip_smoke.py``'s ``step_graph`` phase).

(a) the device-side ``n_valid`` rule against the JAX package's sampling, bit
for bit; (b) the programs (the steps', the back end's chain batch's, the
headline's match) under a guard that raises on every host read;
(c) the programs' steps against the JAX engine's, carried one scan at a
time, at ``bench/parity.py``'s per-step bars, unfused, fused and pipelined;
(d) a store growth, a recenter, a pub growth and a pub clip rebuild: a new
program where a buffer was replaced, the same program where the maps were
written in place (equal to fresh maps from the same rows), and the next step equal, bit for bit, to that of an engine carried fresh
into the same state."""

import contextlib
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.ops.correlative as jc
import roborts_slam_tpu.ops.raycast as jrc
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.correlative as tc
import roborts_slam_tpu_torch.ops.raster as tr
import roborts_slam_tpu_torch.ops.raycast as trc
from roborts_slam_tpu_torch.backend.processor import ROW
from roborts_slam_tpu_torch.bench import headline, lockstep, workload
from roborts_slam_tpu_torch.frontend.processor import SUMMARY
from roborts_slam_tpu_torch.models.scan import LaserModel as TLaser
from roborts_slam_tpu_torch.ops.cuda import launch
from roborts_slam_tpu_torch.step_graph import StepGraph, stage, staged_size, unstage
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
# the fused tests' small configuration: a 1 m link radius, so that the
# out-and-back proposes chains on its way back
OVER = dict(fine_map_resolution=0.02, world_size=24.0, link_scan_max_distance=1.0)
OUT_AND_BACK = list(range(40)) + list(range(39, 23, -1))   # fused from scan 51
TIMES = [0.1 * k for k in range(len(OUT_AND_BACK))]
P_FULL = 640


@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _port(icra, **kw):
    return T.SlamEngine(T.load_config(SIM_YAML, **OVER), TLaser.from_array(icra["laser"]),
                        device="cpu", **kw)


def _feed(eng, icra, ks):
    for k in ks:
        eng.process(icra["ranges"][OUT_AND_BACK[k]], icra["odom"][OUT_AND_BACK[k]], TIMES[k])


# ---- (a) n_valid on the device: the reference's rule, bit for bit ----

def _counts(use):
    return [0, 1, use - 1, 2 * use - 1, 2 * use, P_FULL]


@pytest.mark.parametrize("which", range(6))
@pytest.mark.parametrize("use", [100, 200])
def test_n_valid_rule_on_the_device_matches_jax(use, which):
    """The scan matcher's samples, their validity and the score divisor, and
    the map check's beams, from ``n_valid`` as a () int32 device tensor, for
    n_valid in {0, 1, use - 1, 2 use - 1, 2 use, all P}: equal to the JAX
    package's ``_sample_indices`` / ``_sample_beams`` (bit for bit: tolerance
    0), and to the host int's; one tier's match from either is the same
    tensor bit for bit, its response 0 on an empty scan."""
    n = _counts(use)[which]
    dev_n = torch.tensor(n, dtype=torch.int32)
    ji, jv, jd = jc._sample_indices(jnp.int32(n), use, 2 * use)
    ti, tv, td = tc._sample_indices(dev_n, use, 2 * use, "cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert td.dtype == torch.float32 and td.shape == ()
    assert td.numpy().tobytes() == np.asarray(jd, np.float32).tobytes()
    hi, hv, hd = tc._sample_indices(n, use, 2 * use, "cpu")
    assert torch.equal(hi, ti) and torch.equal(hv, tv) and torch.equal(hd, td)

    rng = np.random.default_rng(which)
    pts = rng.uniform(-3, 3, (P_FULL, 2)).astype(np.float32)
    mask = np.arange(P_FULL) < n
    js, jsv = jrc._sample_beams(jnp.asarray(pts), jnp.asarray(mask), jnp.int32(n), use)
    ts, tsv = trc._sample_beams(torch.as_tensor(pts), torch.as_tensor(mask), dev_n, use)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))

    spec = tgm.ProbMapSpec(resolution=0.05, height=96, width=96, deviation=0.05,
                           blur_offset=0.72)
    probs = torch.as_tensor(rng.uniform(0.0, 1.0, (96, 96)).astype(np.float32))
    params = tc.CorrelativeParams(0.4, 0.05, 0.2, 0.05, 0.3, use, True, tc.COARSE)
    off = torch.tensor([2.4, 2.4])
    pose = torch.tensor([0.1, -0.05, 0.2])
    args = (spec, params, probs, off, torch.as_tensor(pts * 0.3), torch.as_tensor(mask))
    a = tc.correlative_scan_match(*args, dev_n, pose, torch.eye(3))
    b = tc.correlative_scan_match(*args, n, pose, torch.eye(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    if n == 0:
        assert float(a.response) == 0.0


# ---- (b) the region a capture takes reads nothing on the host ----

_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy", "tolist")
_allowed = threading.local()


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor raises while entered (``Tensor.item``,
    ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``cpu``,
    ``numpy``, ``tolist``), but inside the kernel wrappers' plain versions
    (``allowed``), which stand for the CUDA kernels here: on the card the
    kernels size their walks themselves and read nothing."""
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def guard(name):
        orig = saved[name]

        def read(self, *a, **kw):
            if getattr(_allowed, "on", False):
                return orig(self, *a, **kw)
            raise AssertionError(f"host read: Tensor.{name}")
        return read

    for name in _READS:
        setattr(torch.Tensor, name, guard(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _allowed_in(fn):
    def run(*a, **kw):
        _allowed.on = True
        try:
            return fn(*a, **kw)
        finally:
            _allowed.on = False
    return run


@contextlib.contextmanager
def kernels_as_on_the_card(monkeypatch):
    """The ray carve and the ray check wrappers as the step sees them on the
    card: launches that read nothing (their plain versions, allowed)."""
    monkeypatch.setattr(trc, "bad_ray_count", _allowed_in(trc.bad_ray_count))
    monkeypatch.setattr(tr, "ray_mark_image", _allowed_in(tr.ray_mark_image))
    yield


def _program_and_input(eng, icra, kind, k):
    """The engine's program of ``kind`` for scan ``k`` of the out-and-back,
    its staged input copied in (as the engine stages it)."""
    from roborts_slam_tpu_torch.models.scan import ranges_to_packed

    i = OUT_AND_BACK[k]
    pts, msk, nv = ranges_to_packed(icra["ranges"][i], eng.laser, eng.config.max_points)
    ids, slot = None, 0
    if kind != "frontend":
        eng.store.device_arrays(reserve=1)
        slot = eng.store._dev_count
        K = eng.bspec.max_chain_scans
        ids = np.full((2, K), -1, np.int64)
        ids[0, :3] = [0, 1, 2]
        ids[1, :2] = [3, 4]
    if kind == "cursor" and eng._dev_cursor is None:
        eng._dev_cursor = torch.zeros((1,), dtype=torch.int64)
    host = eng._stage_scan(pts, msk, nv, np.asarray(icra["odom"][i], np.float64), TIMES[k],
                           ids, slot, seed=kind == "cursor")
    prog = eng._program(kind, pts.shape[0], None if ids is None else ids.shape)
    prog.staged.copy_(host)
    return prog


def _batch_input(eng, sid=6):
    """A separate chain batch of two chains against stored scan ``sid``."""
    K = eng.bspec.max_chain_scans
    ids = np.full((2, K), -1, np.int64)
    ids[0, :3] = [0, 1, 2]
    ids[1, :2] = [3, 4]
    inits = np.stack([eng.store.poses[sid], eng.store.poses[sid] + 0.01]).astype(np.float32)
    return ids, sid, inits


@pytest.mark.parametrize("kind", ["frontend", "fused", "cursor", "match_chain", "batch"])
def test_capture_region_reads_nothing(icra, monkeypatch, kind):
    """The programs the card captures — ``frontend_step`` (device gate),
    ``fused_frontend_chain_step``, ``fused_cursor_step``, the back end's
    separate chain batch (``Backend._batch_program``) — and one iteration
    of the headline's ``match_chain``, each run once to make its constants
    and then again under a guard on every host read: no read."""
    with kernels_as_on_the_card(monkeypatch):
        if kind == "batch":
            eng = _port(icra)
            _feed(eng, icra, range(8))
            b = eng.backend
            b._batch_on_device(*_batch_input(eng))
            prog = b._programs[(2, eng.bspec.max_chain_scans)]
            with no_host_reads():
                packed = prog.fn(prog.staged)
            assert packed.shape == (2, ROW) and torch.isfinite(packed).all()
            return
        if kind == "match_chain":
            w = workload.headline_workload(beams=181, device="cpu")
            f = headline.match_chain(w)
            f(0, 1)
            with no_host_reads():
                out = f.step()
            assert out.shape == () and torch.isfinite(out)
            return
        eng = _port(icra)
        _feed(eng, icra, range(8))
        prog = _program_and_input(eng, icra, kind, 8)
        prog.fn(prog.staged)
        prog = _program_and_input(eng, icra, kind, 9)
        with no_host_reads():
            packed = prog.fn(prog.staged)
    n = {"frontend": SUMMARY, "fused": SUMMARY + 2 * ROW, "cursor": SUMMARY + 1 + 2 * ROW}[kind]
    assert packed.shape == (n,) and torch.isfinite(packed).all()


def test_chain_batch_program_equals_the_direct_call(icra):
    """The separate chain batch through its program (staged ids, scan id,
    n_valid, inits and centre; the pub map copied into the program's planes)
    equals ``chain_match_batch_gather`` called with host values, bit for bit
    (tolerance 0), twice in a row (the program's buffers reused)."""
    from roborts_slam_tpu_torch.backend.processor import chain_match_batch_gather

    eng = _port(icra)
    _feed(eng, icra, range(10))
    b, st = eng.backend, eng.store
    for sid in (6, 9):
        ids, _, inits = _batch_input(eng, sid)
        rows = b._batch_on_device(ids, sid, inits).clone()
        got = rows[:, :3], rows[:, 3], rows[:, 4:13].reshape(-1, 3, 3)
        _, *pub = st.pub_map_arrays()
        want = chain_match_batch_gather(
            b.spec, *st.device_arrays(), torch.as_tensor(ids), sid, st.n_valid(sid),
            torch.as_tensor(inits), torch.as_tensor(st.poses[sid], dtype=torch.float32), *pub)
        for x, y in zip(got, want):
            assert torch.equal(x, y.to(torch.float32))
    assert len(b._programs) == 1


def test_staged_vector_round_trips():
    """``stage`` / ``unstage``: every input of a scan through the one
    float32 vector, exactly (integers below 2^24)."""
    rng = np.random.default_rng(3)
    P = 37
    pts = rng.normal(size=(P, 2)).astype(np.float32)
    msk = rng.random(P) > 0.3
    ids = rng.integers(-1, 5000, (4, 7))
    host = np.zeros(staged_size(P, ids.shape), np.float32)
    stage(host, pts, msk, 29, np.array([1.25, -3.5, 0.7]), 12.5, slot=511, seed=True, ids=ids)
    d = unstage(torch.as_tensor(host), P, ids.shape)
    np.testing.assert_array_equal(d["points"].numpy(), pts)
    np.testing.assert_array_equal(d["mask"].numpy(), msk)
    assert int(d["n_valid"]) == 29 and d["n_valid"].dtype == torch.int32
    np.testing.assert_array_equal(d["odom"].numpy(), np.float32([1.25, -3.5, 0.7]))
    assert float(d["time"]) == 12.5 and d["slot"].tolist() == [511] and bool(d["seed"])
    np.testing.assert_array_equal(d["ids"].numpy(), ids)
    assert unstage(torch.as_tensor(host[:staged_size(P, None)]), P, None)["ids"] is None


def test_launches_recorded_inside_a_capture_are_not_counted():
    """Inside ``launch.capturing`` a wrapper's count is recorded for the
    graph's replays, not counted; a CPU ``StepGraph`` runs eagerly."""
    seen = []
    launches: list = []
    with launch.capturing(launches, {"tickets": None}):
        launch.counted(seen.append, "k")
        assert launch.capture_scratch() == {"tickets": None}
    assert seen == [] and launches == [(seen.append, ("k",))]
    assert launch.capture_scratch() is None
    launch.counted(seen.append, "k")
    assert seen == ["k"]
    g = StepGraph(lambda staged: staged + 1, 3, "cpu")
    assert not g.capture and torch.equal(g(), torch.ones(3)) and g.last == "eager"
    assert torch.equal(g(), torch.ones(3)) and g.last == "eager" and g.graph is None


# ---- (c) the programs' steps against JAX, one carried scan at a time ----

@pytest.mark.parametrize("mode", ["unfused", "fused", "pipelined"])
def test_program_steps_match_jax_in_lockstep(icra, mode):
    """The out-and-back of the icra log (chains on the way back) fed to the
    JAX engine (blocking, fused unless ``unfused``); before each scan its
    whole state is carried into a fresh port engine on the CPU whose step
    runs through its program (``pipelined``: the cursor program, reconciled
    after the step), and the step is held at ``parity.compare_observations``'
    per-step bars (pose 1e-5 m / rad, score 1e-5, covariance 1e-3 relative,
    the same decisions, map cells but a flipped beam's), at most
    ``parity.TIE_FLIP_CAP`` flips at a discontinuity of the last bits."""
    import roborts_slam_tpu as J
    from roborts_slam_tpu.models.scan import LaserModel as JLaser

    kw = {"unfused": dict(fused_backend=False), "fused": {},
          "pipelined": dict(pipelined_fetch=True)}[mode]
    je = J.SlamEngine(J.load_config(SIM_YAML, **OVER), JLaser.from_array(icra["laser"]),
                      synchronous_backend=True, fused_backend=mode != "unfused")
    feed = [("process", (icra["ranges"][i], icra["odom"][i], TIMES[k]))
            for k, i in enumerate(OUT_AND_BACK)] + [("finish", ())]
    steps = []
    rep = L.lockstep(je, feed, name=mode, on_step=lambda k, row, ref, te: steps.append(
        (te.diag.fused_steps, te.diag.eager_steps, te.diag.step_graph)), **kw)
    L.assert_lockstep(rep)
    assert all(s[2] == "eager: cpu tensors" for s in steps)
    assert sum(s[1] for s in steps) >= len(OUT_AND_BACK) - 2
    if mode != "unfused":
        assert sum(s[0] for s in steps) > 0, "no fused step ran"


# ---- (d) a replaced buffer makes a new program; maps written in place keep it ----

def _bufs(eng, kind):
    st, store = eng.state, eng.store
    b = [st.pub.hits, st.pub.passes, st.coarse.probs, st.fine.probs, st.pose]
    if kind != "frontend":
        b += [store._dev_points, store._dev_masks, store._dev_poses]
    return [(t.data_ptr(), tuple(t.shape)) for t in b]


@pytest.mark.parametrize("event", ["store_growth", "recenter", "pub_growth", "pub_clip"])
def test_an_event_makes_a_new_program_or_writes_in_place(icra, event):
    """After a store capacity doubling or a pub-map growth (buffers
    replaced) every program that holds a replaced buffer is made anew and
    holds the current ones; after a recenter (the match maps written into
    their buffers, offsets moved) or a pub clip rebuild (the pub planes
    rebuilt in place) every program is the same object and its buffers are
    the state's, and the maps written in place equal, bit for bit, fresh
    maps rebuilt from the same rows. Either way the next step equals, bit
    for bit (tolerance 0: summary, maps, store rows), that of an engine
    carried fresh into the same state."""
    eng = _port(icra)
    eng.store._DEV_CAP_START = 16
    _feed(eng, icra, range(53))
    assert eng.diag.fused_steps > 0
    before = {key: (prog, _bufs(eng, key[0])) for key, prog in eng._programs.items()}
    in_place = event in ("recenter", "pub_clip")
    if event == "store_growth":
        eng.store.device_arrays(reserve=eng.store._dev_cap)
    elif event == "recenter":
        rows = _spy_rows(eng, "gather")
        g = eng._shift_granule() * round(0.3 / eng._shift_granule())
        eng._rebuild_match_maps_at(eng._host_fine_off - g, eng._host_coarse_off - g)
        assert eng.diag.recenters == 1
        cfg, st = eng.config, eng.state
        for spec, pmap, blur in ((eng.fspec.coarse_spec, st.coarse, cfg.coarse_map_use_blur),
                                 (eng.fspec.fine_spec, st.fine, cfg.fine_map_use_blur)):
            fresh_map = tr.stamp_scan_batch(
                spec, tgm.make_prob_map(spec, pmap.offset.clone(), "cpu"), *rows[0],
                use_blur=bool(blur))
            assert torch.equal(pmap.probs, fresh_map.probs)
    elif event == "pub_clip":
        rows = _spy_rows(eng, "all_arrays")
        for t in (eng.state.pub.hits, eng.state.pub.passes):
            t.fill_(7.0)                        # stale planes the rebuild must overwrite
        with eng._state_lock:
            eng._rebuild_pub()
        cfg, pub = eng.config, eng.state.pub
        fresh_pub = tr.rebuild_count_map(
            eng.fspec.pub_spec, pub.offset.clone(), *rows[0], cfg.map_update_free_factor,
            cfg.map_update_occu_factor, first_scan_extra=int(cfg.map_min_passthrough))
        assert rows[0][0].shape[0] == len(eng.store)
        assert torch.equal(pub.hits, fresh_pub.hits)
        assert torch.equal(pub.passes, fresh_pub.passes)
    else:
        ps = eng.fspec.pub_spec
        eng._grow_pub_to(ps.width + 256, ps.height + 256, 128, 128)
    fresh = lockstep.carry(lockstep.engine_arrays(eng), "cpu")
    for key, (old, old_bufs) in before.items():
        prog = eng._program(*key)
        replaced = _bufs(eng, key[0]) != old_bufs
        assert replaced == (not in_place and (event == "pub_growth"
                                              or key[0] != "frontend"))
        assert (prog is old) == (not replaced)
    k = 53
    for e in (eng, fresh):
        _feed(e, icra, [k])
    assert eng.last_summary is not None
    assert np.array_equal(eng.last_summary, fresh.last_summary)
    for a, b in zip(_state(eng), _state(fresh)):
        assert np.array_equal(a, b)


def _spy_rows(eng, name):
    """The rows each call of the store's ``name`` returns, recorded (the
    call itself unchanged)."""
    rows, call = [], getattr(eng.store, name)

    def spy(*a, **kw):
        rows.append(call(*a, **kw))
        return rows[-1]

    setattr(eng.store, name, spy)
    return rows


def _state(eng):
    st, n = eng.state, len(eng.store)
    pts, _, poses = eng.store.device_arrays()
    return [t.numpy() for t in (st.pub.hits, st.pub.passes, st.coarse.probs, st.fine.probs,
                                st.coarse.offset, st.fine.offset, st.pose, pts[:n], poses[:n])]
