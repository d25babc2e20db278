"""Port vs JAX package at full width: the three configurations that
``chip_smoke.py`` drives on the card (``roborts_slam_tpu_torch/bench/parity.py``,
``LEGS``), on their own inputs.

- the logs regenerated here hash to those in ``tests/data/jax_full_width.npz``
  (the JAX package's results that the card's ``jax_full_width`` phase is held
  against), and the two packages' simulators agree bit for bit;
- one front-end step per configuration from a state that JAX's engine reached
  on the leg, carried into the port, compared stage by stage on the same
  inputs (``tests/_torch_lockstep.py``'s ``compare_step``);
- the tie classifier, and the bars of the ``jax_full_width`` phase;
- the first 36 scans of leg 3 run free in both engines.

One torch thread: float sums are then taken in one fixed order."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from roborts_slam_tpu_torch.bench import parity
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_full_width_parity", os.path.join(REPO, "scripts", "torch_full_width_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P = _script()


@pytest.fixture(scope="module")
def loop_log():
    return parity.corridor_loop_log()


@pytest.fixture(scope="module")
def fixture():
    return parity.load_fixture()


# ---- the inputs ----

def test_fixture_is_small_and_names_its_writer():
    assert os.path.getsize(parity.FIXTURE) <= 1 << 20
    with np.load(parity.FIXTURE) as z:
        assert "scripts/torch_full_width_parity.py --write" in bytes(z["about"]).decode()
        assert not any(k.endswith(("ranges", "odom")) for k in z.files)   # no log stored


@pytest.mark.parametrize("leg", sorted(parity.LEGS))
def test_regenerated_logs_hash_to_the_fixture(leg, loop_log, fixture):
    inputs = parity.leg_inputs(leg, loop_log)
    assert len(inputs["times"]) == parity.LEGS[leg]["scans"]
    assert parity.inputs_sha256(inputs) == fixture[leg]["sha256"]


def test_simulators_agree_bit_for_bit():
    """The JAX package's simulator and the port's on a short stretch of the
    corridor loop: the same ranges, odometry, stamps and truth."""
    from roborts_slam_tpu.io.pgm import GroundTruthMap as JMap
    from roborts_slam_tpu.io.simulate import path_to_trajectory as jpath
    from roborts_slam_tpu.io.simulate import simulate_log as jsim
    from roborts_slam_tpu.models.scan import LaserModel as JLaser
    from roborts_slam_tpu_torch.io.simulate import path_to_trajectory, simulate_log

    path = parity.corridor_loop_path(0.05)
    laser = parity.loop_laser()
    mine = simulate_log(parity.corridor_loop_map(), laser,
                        trajectory=path_to_trajectory(path, speed=1.0, scan_rate=10.0),
                        odom_error=(0.03, 0.03, 0.05), range_noise=0.01, seed=parity.LOOP_SEED)
    theirs = jsim(parity.corridor_loop_map(JMap), JLaser.from_array(laser.to_array()),
                  trajectory=jpath(path, speed=1.0, scan_rate=10.0),
                  odom_error=(0.03, 0.03, 0.05), range_noise=0.01, seed=parity.LOOP_SEED)
    assert len(mine) == len(theirs) >= 30
    for k in ("ranges", "odom", "times", "gt_poses"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(theirs, k))


# ---- the tie classifier ----

def _grid():
    rng = np.random.default_rng(7)
    g = rng.uniform(0.2, 0.7, (5, 4, 4)).astype(np.float32)
    g[2, 1, 1] = 0.9                                  # best
    g[3, 2, 2] = 0.9 - 0.01 + 2e-6                    # just inside the line
    g[1, 0, 3] = 0.9 - 0.01 - 0.003                   # an outsider 3e-3 below it
    return g


@pytest.mark.parametrize("change,kind", [
    (None, "same"),
    (((3, 2, 2), -4e-6), "tie_flip"),       # pushed across the line, 2e-6 from it
    (((1, 0, 3), +4e-3), "fault"),          # an outsider 3e-3 away pulled inside
    (((0, 0, 0), +1e-4), "fault"),          # scores apart by 1e-4, no flip
])
def test_tie_classifier(change, kind):
    ref = _grid()
    got = ref.copy()
    if change is not None:
        got[change[0]] += np.float32(change[1])
    out = parity.classify_tier(ref, got)
    assert out["kind"] == kind, out
    assert out["ties"] == 2 and out["line"] == pytest.approx(0.89)
    assert out["closest_outside_below_line"] == pytest.approx(0.003, abs=1e-6)
    assert out["lowest_inside_above_line"] == pytest.approx(2e-6, abs=1e-6)
    if kind == "tie_flip":
        assert out["flipped"] == 1 and out["flipped_max_dist_to_line"] <= 1e-5


# ---- the bars of the card's jax_full_width phase ----

def _record(kept=100, closures=1, ate=0.04, shift=0.0):
    ids = np.arange(kept) * 2
    poses = np.stack([ids * 0.1, np.zeros(kept), np.zeros(kept)], 1).astype(np.float32)
    poses[:, 1] += shift
    return dict(kept_ids=ids, poses=poses, links=kept - 1, closures=closures, solves=1,
                pub_map=np.zeros((8, 8), np.int8), ate_m=ate)


@pytest.mark.parametrize("change,failed", [
    ({}, []),
    ({"kept": 98}, []),                                     # 2 % off: within
    ({"kept": 97}, ["kept count beyond 2 %"]),
    ({"closures": 2}, ["closure count"]),
    ({"ate": 0.0501}, ["ATE above max(1.25 x JAX's, JAX's + 5 mm)"]),
    ({"ate": 0.05}, []),                                    # 1.25 x 0.04
    ({"shift": 3e-3}, []),                                  # printed, not a bar
])
def test_jax_full_width_bars(change, failed):
    ref = dict(_record(), sha256="a" * 64)
    report, bars = parity.compare_leg(_record(**change), ref, "a" * 64)
    assert bars == failed
    assert report["sha256_equal"]
    if "shift" in change:
        gap = report["pose_gap_on_shared_kept"]
        assert gap["over_2e-3"] == 100 and gap["max_m"] == pytest.approx(3e-3, rel=1e-3)
        assert report["first_parting_scan"] == 0
    _, bars = parity.compare_leg(_record(), ref, "b" * 64)
    assert bars == ["log hash"]


def test_ate_bar_takes_the_larger_allowance():
    assert parity.ate_bar(0.01) == pytest.approx(0.015)
    assert parity.ate_bar(0.04) == pytest.approx(0.05)


def test_fixture_round_trip(tmp_path):
    rec = _record()
    path = tmp_path / "f.npz"
    parity.save_fixture(path, {"legx": rec}, {"legx": "c" * 64}, "about")
    back = parity.load_fixture(path)["legx"]
    assert back["sha256"] == "c" * 64 and back["closures"] == 1
    np.testing.assert_array_equal(back["kept_ids"], rec["kept_ids"])
    np.testing.assert_array_equal(back["pub_map"], rec["pub_map"])


# ---- one step from JAX's state, stage by stage ----

# (leg, fed scan): leg 1's first scan on the way back (matched against the map
# made on the way out), and the first scans at which the free runs of legs 3
# (by more than 1 mm) and 4 part
ONE_SCAN = [("leg1", 70), ("leg3", 41), ("leg4", 29)]


@pytest.fixture(scope="module")
def leg3_run(loop_log):
    """Leg 3's first 36 scans: the JAX engine in lockstep (the port carried
    into its state before each), the port free beside it; then JAX's on to
    scan 41 with its state before scan 41 recorded. ((JAX's record, the
    port's free record), (JAX's engine, its state before 41), the lockstep
    report)."""
    inputs = leg3_inputs(parity.LOOP_SEED, loop_log)
    je, te = P.jax_engine("leg3", inputs), P.port_engine("leg3", inputs)
    scans = L.scans(inputs["ranges"], inputs["odom"], inputs["times"])
    rep = L.lockstep(je, scans, name="leg3 first 36")
    for k in range(len(scans)):
        P.feed(te, inputs, k)
    free = (parity.run_record(je, inputs["times"], inputs["gt"]),
            parity.run_record(te, inputs["times"], inputs["gt"]))
    return free, _carry(je, parity.leg_inputs("leg3", loop_log), 36, 41), rep


def _carry(je, inputs, start, k):
    tap = L.StepTap(je)
    try:
        for i in range(start, k):
            P.feed(je, inputs, i)
        tap.armed = True
        P.feed(je, inputs, k)
    finally:
        tap.close()
    assert tap.seen is not None
    return je, tap.seen


@pytest.fixture(scope="module", params=ONE_SCAN, ids=[f"{leg}_scan{k}" for leg, k in ONE_SCAN])
def one_step(request, loop_log, leg3_run):
    leg, k = request.param
    inputs = parity.leg_inputs(leg, loop_log)
    if leg == "leg3":
        je, seen = leg3_run[1]
    else:
        je, seen = _carry(P.jax_engine(leg, inputs), inputs, 0, k)
    return leg, L.compare_step(je, P.port_engine(leg, inputs), seen, iterations=False)


def test_one_step_from_a_carried_jax_state(one_step):
    leg, res = one_step
    assert res["predict"]["max_abs_diff"] <= 1e-5
    if "optimizer" in res:                  # leg 4: the default configuration
        opt = res["optimizer"]
        assert opt["pose_max_abs_diff"] <= 1e-5
        assert opt["fell_back_to_coarse_tier"][0] == opt["fell_back_to_coarse_tier"][1]
    for name, tier in res["tiers"].items():
        same = tier["same_input"]
        # scores within 1e-5, or apart only where a sample's cell coordinate
        # straddles a cell edge by less than 1e-3 cells (f32 rounding)
        assert same["kind"] in ("same", "tie_flip", "cell_edge_flip"), (name, same)
        if same["kind"] != "cell_edge_flip":
            assert same["scores_max_abs_diff"] <= 1e-5, (name, same)
        assert same["pose_max_abs_diff"] <= 1e-5, (name, same)
    pen = res["map_feedback_penalty"]
    assert pen["f32_steps_apart"] <= 1            # the same bad-ray count
    for name, u in res["map_update_at_port_pose"].items():
        assert u["cells_changed_by_one_only"] == 0 and u["values_max_abs_diff"] == 0.0, name
    step = res["step"]
    assert step["pose_accepted"][0] == step["pose_accepted"][1]
    assert step["map_updated"][0] == step["map_updated"][1]
    assert step["jax_step_vs_jax_chain"] == 0.0 and step["port_step_vs_port_chain"] == 0.0
    assert res["differ_on_same_input"] == []
    if res["kind"] != "tie_flip":
        assert step["gap_m"] <= parity.POS_TOL and step["gap_rad"] <= parity.ANG_TOL, step


# ---- leg 3 free, the small-size bar ----

LEG3_FREE_SCANS = 36
# free runs over corridor logs simulated from other seeds (the first is
# leg 3's own); the tests take FREE_VARIANTS
VARIANTS = (parity.LOOP_SEED, 21, 22, 23, 24, 25, 26, 27)
FREE_VARIANTS = VARIANTS[:3]


def leg3_inputs(seed: int, loop_log=None) -> dict:
    """Leg 3's first ``LEG3_FREE_SCANS`` scans: of its own log for the loop
    seed (``loop_log`` when already made), else of a 0.07-lap log (≈ 46
    scans) simulated from ``seed`` with the same noise."""
    if seed == parity.LOOP_SEED:
        log = loop_log if loop_log is not None else parity.corridor_loop_log()
    else:
        log = parity.corridor_loop_log(laps=0.07, seed=seed)
    n = LEG3_FREE_SCANS
    return dict(laser=log.laser, ranges=log.ranges[:n], odom=log.odom[:n],
                times=log.times[:n], gt=log.gt_poses[:n])


def free_run(seed: int, loop_log=None) -> tuple:
    """Both engines free over ``leg3_inputs(seed)`` under leg 3's
    configuration. (JAX's record, the port's)."""
    inputs = leg3_inputs(seed, loop_log)
    je, te = P.jax_engine("leg3", inputs), P.port_engine("leg3", inputs)
    for k in range(len(inputs["times"])):
        P.feed(je, inputs, k)
        P.feed(te, inputs, k)
    return (parity.run_record(je, inputs["times"], inputs["gt"]),
            parity.run_record(te, inputs["times"], inputs["gt"]))


@pytest.mark.parametrize("form", ["lockstep"] + [f"free-{v}" for v in FREE_VARIANTS])
def test_leg3_first_36_scans_free(leg3_run, loop_log, form):
    """Leg 3's configuration at full width (``configs/real_robot.yaml``:
    de-distortion, the 15 m match-map window) over the first 36 scans of
    the corridor loop. ``lockstep``: each step from the JAX engine's
    carried state at the per-step bars (pose 1e-5 m / 1e-5 rad, score,
    covariance, decisions, map cells), at most 3 tie flips.
    ``free-<seed>``: both engines free over the log simulated from that
    seed (20: leg 3's own), at the bars of a whole run (the same closures
    and solves, kept within one scan, ATE within max(1.25 x JAX's, JAX's +
    5 mm); the count of poses beyond 2e-3 m printed)."""
    if form == "lockstep":
        L.assert_lockstep(leg3_run[2])
        return
    seed = int(form.split("-")[1])
    jrec, trec = leg3_run[0] if seed == parity.LOOP_SEED else free_run(seed)
    report = L.assert_free(jrec, trec, f"leg3 first 36 {form}")
    assert report["kept"]["port"] >= 20


def test_script_lockstep_reports_the_helpers_gaps(leg3_run, loop_log, monkeypatch, capsys):
    """``scripts/torch_full_width_parity.py --lockstep leg3:8`` runs the
    shared helper: its per-step lines carry the same pose gaps, map cells
    and decisions as the helper's report on the same scans."""
    monkeypatch.setattr(P.parity, "corridor_loop_log", lambda: loop_log)
    capsys.readouterr()
    P.lockstep("leg3:8")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    rows, summary = lines[:-1], lines[-1]
    assert [r["scan"] for r in rows] == list(range(8)) and summary["leg"] == "leg3"
    for got, want in zip(rows, leg3_run[2].rows[:8]):
        assert got["pose_gap"] == [want.get("pose_gap_m"), want.get("pose_gap_rad")]
        assert got["kept"] == want["kept"] and got["failed"] == want["failed"]
        assert got["fine_probs"] == want["maps"]["fine_probs"]["differing"]
