"""The lockstep harness itself (``tests/_torch_lockstep.py``, the per-step
bars of ``roborts_slam_tpu_torch/bench/parity.py``): a JAX engine's state
carried into the port comes back bit for bit; a port step from a state 1e-4
m off fails the per-step bar; a step off its pose bar counts as a tie flip
only where the tier grids say so, and a fourth tie flip fails the run.
Inputs: ``tests/data/golden_icra.npz`` under ``configs/simulation.yaml`` at
the narrow size of ``test_torch_engine.py``."""

import os

import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.bench import parity
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
OVER = dict(fine_map_resolution=0.02, world_size=24.0, link_scan_max_distance=1.0)
ORDER = list(range(30)) + list(range(29, -1, -1))     # out and back: chains, a closure


@pytest.fixture(scope="module")
def icra():
    return np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))


def _feed(icra, ks):
    return [("process", (icra["ranges"][ORDER[k]], icra["odom"][ORDER[k]], 0.1 * k))
            for k in ks]


@pytest.fixture(scope="module")
def jax_after(icra):
    """The JAX engine (fused, the default) after the out-and-back: chain
    links, a closure and its solve."""
    je = J.SlamEngine(J.load_config(SIM_YAML, **OVER), JLaser.from_array(icra["laser"]),
                      synchronous_backend=True)
    for _, args in _feed(icra, range(len(ORDER))):
        je.process(*args)
    assert je.backend.num_loop_closures >= 1 and je.backend.num_solves >= 1
    return je


def test_carried_state_round_trips_bit_for_bit(jax_after):
    """JAX -> port -> arrays: every array of the JAX engine's state (maps,
    scalars, store, graph edges and their information, counters, gating
    memory, the float64 host offsets and map->odom) read back from the
    port engine equals JAX's, bit for bit."""
    z = L.engine_arrays(jax_after)
    back = L.engine_arrays(L.carry(z))
    assert set(back) == set(z)
    for k, v in z.items():
        if k == "state":
            assert set(back[k]) == set(v)
            for q in v:
                np.testing.assert_array_equal(back[k][q], v[q], err_msg=q)
            continue
        if k == "config_json":
            assert bytes(back[k]) == bytes(v)
            continue
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)
    assert len(z["store_times"]) > 40 and len(z["edge_st"]) > len(z["store_times"])
    assert z["host_fine_offset"].dtype == np.float64


def test_perturbed_state_fails_the_step_bar(jax_after, icra):
    """The port carried into JAX's state but 1e-4 m off in x: its next step
    misses the pose bar by about that much, and no tier names a tie flip."""
    je = J.SlamEngine(J.load_config(SIM_YAML, **OVER), JLaser.from_array(icra["laser"]),
                      synchronous_backend=True)
    for _, args in _feed(icra, range(12)):
        je.process(*args)
    te = L.carry(L.engine_arrays(je))
    te.state.pose[0] += 1e-4
    te._host_pose[0] += 1e-4
    rep = L.lockstep(je, _feed(icra, range(12, 13)), first=te)
    row = rep.rows[0]
    assert row["pose_gap_m"] > 5 * parity.STEP_POS_TOL
    assert "pose" in row["failed"] and row["not_a_tie_flip"]["pose"] == "fault"
    assert rep.failed() and not rep.tie_flips
    # the same step carried exactly agrees
    assert not L.lockstep(je, _feed(icra, range(13, 15))).failed()


def _grid():
    rng = np.random.default_rng(7)
    g = rng.uniform(0.2, 0.7, (5, 4, 4)).astype(np.float32)
    g[2, 1, 1] = 0.9                                  # best
    g[3, 2, 2] = 0.9 - 0.01 + 2e-6                    # just inside the line
    return g


def _row(gap):
    s = np.zeros(15)
    s[12] = s[13] = 1.0
    obs = lambda dx: {"kept": True, "summary": s + np.r_[dx, np.zeros(14)], "edges": [],
                      "closures": 0, "solves": 0, "recenters": 0, "pub_shape": (8, 8),
                      "poses": np.zeros((1, 3)),
                      "maps": {p: np.zeros((8, 8), np.float32) for p in parity.MAP_PLANES}}
    before = {"solves": 0, "recenters": 0, "pub_shape": (8, 8)}
    return parity.compare_observations(obs(0.0), obs(gap), before, before)


def test_tie_flips_are_counted_and_capped():
    """A step off its pose bar whose tier grids differ only by a candidate
    pushed 4e-6 across the tie line is a tie flip: counted, with its
    margins, not failed; a step whose grids differ by 1e-4 is not; a fourth
    tie flip fails the run. The covariance's window likewise: a swap at the
    20th score within 1e-5 is a flip, one 3e-3 away is not."""
    ref = _grid()
    got = ref.copy()
    got[3, 2, 2] -= np.float32(4e-6)
    flip = parity.classify_tier(ref, got)
    assert flip["kind"] == "tie_flip" and flip["flipped_max_dist_to_line"] <= 1e-5
    rep = parity.LockstepReport("made up")
    assert not _row(2e-6)["pose_bar"] and _row(3e-3)["pose_bar"]
    for k in range(3):
        rep.add(k, _row(3e-3), {"pose": flip["kind"], "tiers": {"super_fine": flip}})
    rep.add(3, _row(2e-6))
    assert len(rep.tie_flips) == 3 and not rep.failed()
    assert rep.summary()["tie_flips"][0]["tiers"]["super_fine"]["flipped"] == 1
    far = ref.copy()
    far[0, 0, 0] += np.float32(1e-4)
    rep2 = parity.LockstepReport()
    rep2.add(0, _row(3e-3), {"pose": parity.classify_tier(ref, far)["kind"]})
    assert rep2.failed() == ["scan 0: pose"]
    rep.add(4, _row(3e-3), {"pose": "tie_flip"})
    assert rep.failed() == ["4 tie flips, more than 3"]
    # the covariance's window: the 20 best above min(best - 0.1, 0.5)
    g = np.linspace(0.6, 0.9, 80).astype(np.float32).reshape(5, 4, 4)
    kth = np.sort(g.reshape(-1))[-20]
    g[g == np.sort(g.reshape(-1))[-21]] = kth - np.float32(2e-6)      # the 21st, 2e-6 below
    near = g.copy()
    near[g == kth - np.float32(2e-6)] = kth + np.float32(2e-6)        # passes the 20th
    assert parity.classify_top(g, g)["kind"] == "same"
    assert parity.classify_top(g, near)["kind"] == "top_flip"
    jump = g.copy()
    jump[0, 0, 0] = kth + np.float32(3e-3)            # a low candidate jumps in
    assert parity.classify_top(g, jump)["kind"] == "fault"


def test_a_later_flip_does_not_excuse_an_earlier_fault():
    """The verdict follows the chain of tiers: a tie flip at the fine tier
    counts only where the coarse tier is the same; a coarse tier apart by
    1e-4 makes the step a fault whatever the tiers after it show, and so
    does a covariance window flip after a tier whose tie sets differ."""
    ref = _grid()
    flip, far = ref.copy(), ref.copy()
    flip[3, 2, 2] -= np.float32(4e-6)
    far[0, 0, 0] += np.float32(1e-4)
    tier = lambda g: (parity.classify_tier(ref, g), parity.classify_top(ref, g))
    (same_t, same_w), (flip_t, flip_w), (far_t, far_w) = (tier(g) for g in (ref, flip, far))
    chain = lambda *tiers: parity.classify_chain(
        {n: t for n, (t, _) in zip(("coarse", "fine", "super_fine"), tiers)},
        {n: w for n, (_, w) in zip(("coarse", "fine", "super_fine"), tiers)})
    assert flip_t["kind"] == "tie_flip" and far_t["kind"] == "fault"
    assert chain((same_t, same_w), (flip_t, flip_w), (same_t, same_w))["pose"] == "tie_flip"
    assert chain((far_t, far_w), (flip_t, flip_w), (same_t, same_w))["pose"] == "fault"
    assert chain((same_t, same_w), (same_t, same_w), (same_t, same_w))["pose"] == "fault"
    top = ({"kind": "same"}, {"kind": "top_flip"})
    assert chain((same_t, same_w), top)["cov"] == "top_flip"
    assert chain((flip_t, same_w), top)["cov"] == "fault"


def test_map_cells_off_the_flipped_beams_fail():
    """A map cell that differs where no beam's endpoint cell moved between
    the two poses fails the map bar; a cell on a flipped beam does not."""
    from roborts_slam_tpu_torch.models.grid_map import CountMapSpec

    spec = CountMapSpec(resolution=0.05, width=64, height=64, max_ray_cells=64)
    pts = np.zeros((4, 2), np.float32)
    pts[:, 0] = [0.475 - 1e-5, 0.8, 1.0, 1.2]        # the first 2e-4 cells short of an edge
    mask = np.ones(4, bool)
    off = np.array([1.6, 1.6], np.float32)             # the sensor in cell (32, 32)
    a, b = np.zeros(3), np.array([2e-5, 0.0, 0.0])    # b moves x by 2e-5 m: 4e-4 cells
    named, beams, edge = parity.map_flip_cells(spec, off, pts, mask, a, b)
    assert beams == 1 and edge <= 1e-3
    assert named[32, 32:43].all() and named.sum() == 11          # its ray, cells 32..42
    for half, cells in ((0, 2), (2, 30)):                      # endpoint cells 41, 42
        named, _, _ = parity.map_flip_cells(spec, off, pts, mask, a, b, half)
        assert named.sum() == cells and named[32, 41] and named[32, 42]
    before = {"solves": 0, "recenters": 0, "pub_shape": (64, 64)}
    s = np.zeros(15)
    s[12] = s[13] = 1.0
    obs = lambda pose, cell: {
        "kept": True, "summary": np.r_[pose, s[3:]], "edges": [], "closures": 0,
        "solves": 0, "recenters": 0, "pub_shape": (64, 64), "poses": np.zeros((1, 3)),
        "maps": {p: np.zeros((64, 64), np.float32) + (np.arange(64 * 64).reshape(64, 64) == cell)
                 for p in parity.MAP_PLANES}}
    planes = {p: (spec, off, None) for p in parity.MAP_PLANES}
    on_ray = parity.compare_observations(obs(a, -1), obs(b, 32 * 64 + 41), before, before,
                                         scan=(pts, mask), planes=planes)
    assert not on_ray["failed"] and on_ray["maps"]["pub_hits"]["unnamed"] == 0
    off_ray = parity.compare_observations(obs(a, -1), obs(b, 20 * 64 + 20), before, before,
                                          scan=(pts, mask), planes=planes)
    assert "pub_hits cells" in off_ray["failed"]
