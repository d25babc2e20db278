"""Full-width parity with the JAX package: the inputs of the legs that
``chip_smoke.py`` drives at full width, the tie classifier of the
correlative matcher, and the comparison of a run with the JAX package's
stored results.

The machine with the card has no JAX. ``scripts/torch_full_width_parity.py
--write`` runs the JAX package on the CPU over the exact inputs of legs 1, 3
and 4 and writes what it got into ``tests/data/jax_full_width.npz``
(``FIXTURE``); ``chip_smoke.py``'s ``jax_full_width`` phase holds the card's
legs against that file with ``compare_leg``. Logs are never stored: they are
made again here (from ``tests/data/golden_willow.npz`` or from a seed) and
their SHA-256 is held against the one in the file.

Nothing here imports JAX; ``leg_record`` reads any engine with the port's
attribute names (the JAX engine has the same ones).
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from ..ops.correlative import K_RESPONSE_FILTER_TOLERANCE

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "tests" / "data" / "jax_full_width.npz"
POS_TOL, ANG_TOL = 2e-3, 2e-3      # the main path's trajectory bar (m, rad)
LOOP_SEED = 20                     # seed of the simulated corridor-loop log
LOOP_LAPS = 1.15                   # laps of the 66.3 m centre line

# The three configurations at full width, as chip_smoke.py builds them:
# ``config`` a YAML under the repository (None: ``SlamConfig()``), ``over``
# the fields replaced on it, ``world_size`` the engine's argument, ``log``
# the input and ``scans`` how many of its scans are fed.
LEGS = {
    "leg1": dict(config="configs/simulation.yaml",
                 over={"max_points": 1152, "world_size": 30.0},
                 world_size=30.0, log="willow_out_and_back", scans=140,
                 force_optimize=True),
    "leg3": dict(config="configs/real_robot.yaml", over={}, world_size=None,
                 log="corridor_loop", scans=762, force_optimize=False),
    "leg4": dict(config=None, over={"max_points": 1152}, world_size=40.0,
                 log="corridor_loop", scans=200, force_optimize=False),
}


# ---- inputs ----

def corridor_loop_map(GroundTruthMap=None):
    """Ground truth of the corridor loop, built in memory at 0.05 m cells: a
    closed corridor 3 m wide round a solid 18 m x 10 m block inside a
    24 m x 16 m hall. Texture every 2 m on both sides of every corridor:
    door recesses (0.8 m wide, 0.5 m deep) in the outer wall, buttresses
    (0.5 m wide, 0.3 m deep) on the block."""
    if GroundTruthMap is None:
        from ..io.pgm import GroundTruthMap
    res = 0.05
    x0, y0 = -1.0, -1.0                           # world corner of cell (0, 0)
    occ = np.ones((int(18 / res), int(26 / res)), bool)

    def box(xa, xb, ya, yb, value):
        occ[int(round((ya - y0) / res)):int(round((yb - y0) / res)),
            int(round((xa - x0) / res)):int(round((xb - x0) / res))] = value

    box(0, 24, 0, 16, False)                      # the hall
    box(3, 21, 3, 13, True)                       # the block
    for x in np.arange(1.0, 23.0, 2.0):
        box(x, x + 0.8, -0.5, 0, False)
        box(x + 1, x + 1.8, 16, 16.5, False)
    for y in np.arange(1.0, 15.0, 2.0):
        box(-0.5, 0, y, y + 0.8, False)
        box(24, 24.5, y + 1, y + 1.8, False)
    for x in np.arange(4.0, 20.0, 2.0):
        box(x, x + 0.5, 2.7, 3, True)
        box(x + 1, x + 1.5, 13, 13.3, True)
    for y in np.arange(4.0, 12.0, 2.0):
        box(2.7, 3, y, y + 0.5, True)
        box(21, 21.3, y + 1, y + 1.5, True)
    return GroundTruthMap(occupancy=occ, free=~occ, resolution=res,
                          origin=np.array([x0, y0]))


def corridor_loop_path(laps: float) -> np.ndarray:
    """Centre line of the corridor (a 21 m x 13 m rectangle with corners
    rounded at 1 m radius, 66.3 m round), anticlockwise from the middle of
    the bottom corridor, as a polyline of 2 cm steps over ``laps`` laps."""
    r, ds = 1.0, 0.02
    xa, xb, ya, yb = 1.5, 22.5, 1.5, 14.5
    pts = []

    def line(p, q):
        n = max(int(np.hypot(q[0] - p[0], q[1] - p[1]) / ds), 1)
        pts.extend(np.linspace(p, q, n, endpoint=False))

    def arc(c, a0):
        n = int(r * np.pi / 2 / ds)
        a = a0 + np.linspace(0, np.pi / 2, n, endpoint=False)
        pts.extend(np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], -1))

    line((12.0, ya), (xb - r, ya))
    arc((xb - r, ya + r), -np.pi / 2)
    line((xb, ya + r), (xb, yb - r))
    arc((xb - r, yb - r), 0.0)
    line((xb - r, yb), (xa + r, yb))
    arc((xa + r, yb - r), np.pi / 2)
    line((xa, yb - r), (xa, ya + r))
    arc((xa + r, ya + r), np.pi)
    line((xa + r, ya), (12.0, ya))
    lap = np.asarray(pts)
    whole, part = int(laps), laps - int(laps)
    return np.concatenate([lap] * whole + [lap[:int(len(lap) * part) + 1]])


def loop_laser():
    """The corridor log's lidar: 1081 beams over 270°, 10 m, 10 Hz sweep."""
    from ..models.scan import LaserModel

    return LaserModel(angle_min=-np.deg2rad(135.0), angle_max=np.deg2rad(135.0),
                      range_min=0.05, range_max=10.0, num_beams=1081,
                      scan_time=0.025)


def corridor_loop_log(laps: float = LOOP_LAPS, seed: int = LOOP_SEED):
    """The corridor-loop ``ScanLog`` (1.15 laps at 1 m/s = 762 scans),
    simulated with the odometry error (0.03, 0.03, 0.05) and 1 cm range
    noise from ``seed``. About 20 s of NumPy ray casting."""
    from ..io.simulate import path_to_trajectory, simulate_log

    traj = path_to_trajectory(corridor_loop_path(laps), speed=1.0, scan_rate=10.0)
    return simulate_log(corridor_loop_map(), loop_laser(), trajectory=traj,
                        odom_error=(0.03, 0.03, 0.05), range_noise=0.01,
                        seed=seed)


def willow_out_and_back(willow):
    """Legs 1-2's feed of ``golden_willow.npz`` (given loaded): its scans
    out, then the same scans in reverse order with times continuing upward.
    Returns (order, feed_times)."""
    times = willow["times"]
    n = len(times)
    order = list(range(n)) + list(range(n - 1, -1, -1))
    dt = float(times[1] - times[0])
    return order, [float(times[0]) + dt * k for k in range(len(order))]


def leg_inputs(leg: str, loop_log=None) -> dict:
    """The scans ``leg`` feeds, in feed order: ``laser`` (a ``LaserModel``),
    ``ranges``, ``odom``, ``times`` and the simulated truth ``gt`` (None
    for the willow log). ``loop_log``: the corridor log when already made."""
    from ..models.scan import LaserModel

    spec = LEGS[leg]
    if spec["log"] == "willow_out_and_back":
        w = np.load(ROOT / "tests" / "data" / "golden_willow.npz")
        order, feed_times = willow_out_and_back(w)
        return dict(laser=LaserModel.from_array(w["laser"]),
                    ranges=w["ranges"][order], odom=w["odom"][order],
                    times=np.asarray(feed_times), gt=None)
    log = loop_log if loop_log is not None else corridor_loop_log()
    n = spec["scans"]
    return dict(laser=log.laser, ranges=log.ranges[:n], odom=log.odom[:n],
                times=log.times[:n], gt=log.gt_poses[:n])


def inputs_sha256(inputs: dict) -> str:
    """SHA-256 of a fed log (``leg_inputs``' dict): the laser's parameters,
    then ranges, odometry and stamps, each as little-endian float64 in C
    order."""
    h = hashlib.sha256()
    for a in (inputs["laser"].to_array(), inputs["ranges"], inputs["odom"], inputs["times"]):
        h.update(np.ascontiguousarray(np.asarray(a, "<f8")).tobytes())
    return h.hexdigest()


# ---- what a run leaves ----

def kept_fed_ids(traj: np.ndarray, times: np.ndarray) -> np.ndarray:
    """The fed indices of the kept scans: stamps are unique per fed scan,
    and the trajectory's first column is the kept scans' stamps."""
    index = {float(t): i for i, t in enumerate(np.asarray(times, np.float64))}
    return np.array([index[float(t)] for t in traj[:, 0]], np.int64)


def leg_record(engine, inputs: dict, ate=None) -> dict:
    """What the fixture stores of one leg's run: the kept scans' fed ids,
    their poses (float32), the link, closure and solve counts, the ATE
    against the truth where there is one (``ate(traj, gt, times)``) and the
    published map as int8 (-1 / 0 / 100)."""
    traj = engine.trajectory_array()
    rec = dict(kept_ids=kept_fed_ids(traj, inputs["times"]),
               poses=np.asarray(traj[:, 1:4], np.float32),
               links=int(engine.backend.num_links),
               closures=int(engine.backend.num_loop_closures),
               solves=int(engine.backend.num_solves),
               pub_map=np.asarray(engine.get_pub_map()).astype(np.int8),
               ate_m=float("nan"))
    if inputs["gt"] is not None and ate is not None:
        rec["ate_m"] = float(ate(traj, inputs["gt"], inputs["times"]))
    return rec


def port_ate(traj, gt, times) -> float:
    """ATE RMSE after alignment, by the port's ``utils/evaluation.py``."""
    from ..utils.evaluation import ate_rmse, match_by_time

    est, g = match_by_time(traj, gt, times)
    return ate_rmse(est, g)


def save_fixture(path, records: dict, hashes: dict, about: str) -> None:
    """Write the per-leg records and log hashes as one compressed ``.npz``
    (keys ``<leg>/<field>``)."""
    data = {"about": np.frombuffer(about.encode(), np.uint8)}
    for leg, rec in records.items():
        data[f"{leg}/sha256"] = np.frombuffer(hashes[leg].encode(), np.uint8)
        for k, v in rec.items():
            data[f"{leg}/{k}"] = np.asarray(v)
    np.savez_compressed(path, **data)


def load_fixture(path=FIXTURE) -> dict:
    """{leg: record with ``sha256``} from ``save_fixture``'s file."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if "/" not in key:
                continue
            leg, field = key.split("/", 1)
            v = z[key]
            if field == "sha256":
                v = bytes(v).decode()
            elif v.ndim == 0:
                v = v.item()
            out.setdefault(leg, {})[field] = v
    return out


# ---- comparison ----

def ate_bar(ref_ate: float) -> float:
    """The port's ATE may be at most max(1.25 x JAX's, JAX's + 5 mm)."""
    return max(1.25 * ref_ate, ref_ate + 0.005)


def pose_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 2) per pose: position gap (m) and wrapped angle gap (rad)."""
    pos = np.abs(a[:, :2].astype(np.float64) - b[:, :2]).max(1)
    d = a[:, 2].astype(np.float64) - b[:, 2]
    return np.stack([pos, np.abs(np.arctan2(np.sin(d), np.cos(d)))], 1)


def compare_leg(got: dict, ref: dict, sha256: str) -> tuple[dict, list[str]]:
    """Hold one leg's record (``leg_record``) against JAX's (``ref``, from
    the fixture). Returns the report and the list of failed bars: the logs'
    hashes equal, the closure counts equal, the kept count within 2 % of
    JAX's, the ATE within ``ate_bar``."""
    kj, kp = np.asarray(ref["kept_ids"]), np.asarray(got["kept_ids"])
    shared, ij, ip = np.intersect1d(kj, kp, return_indices=True)
    gap = pose_gap(np.asarray(got["poses"])[ip], np.asarray(ref["poses"])[ij])
    far = (gap[:, 0] > POS_TOL) | (gap[:, 1] > ANG_TOL)
    differ = np.setxor1d(kj, kp)
    first = [int(differ.min())] if differ.size else []
    if far.any():
        first.append(int(shared[np.argmax(far)]))
    pj, pp = np.asarray(ref["pub_map"]), np.asarray(got["pub_map"])
    report = {
        "sha256_equal": sha256 == ref["sha256"],
        "kept": {"port": int(kp.size), "jax": int(kj.size)},
        "kept_decisions_differing": int(differ.size),
        "first_parting_scan": min(first) if first else None,
        "links": {"port": got["links"], "jax": ref["links"]},
        "closures": {"port": got["closures"], "jax": ref["closures"]},
        "solves": {"port": got["solves"], "jax": ref["solves"]},
        "pose_gap_on_shared_kept": {
            "scans": int(shared.size),
            "max_m": float(gap[:, 0].max()) if shared.size else None,
            "median_m": float(np.median(gap[:, 0])) if shared.size else None,
            "max_rad": float(gap[:, 1].max()) if shared.size else None,
            "over_2e-3": int(far.sum())},
        "ate_m": {"port": got["ate_m"], "jax": ref["ate_m"]},
        "pub_map_cells_differing": (int((pj != pp).sum()) if pj.shape == pp.shape
                                    else f"shapes {list(pp.shape)} / {list(pj.shape)}"),
        "pub_map_cells": int(pj.size),
    }
    failed = []
    if not report["sha256_equal"]:
        failed.append("log hash")
    if got["closures"] != ref["closures"]:
        failed.append("closure count")
    if abs(kp.size - kj.size) > 0.02 * kj.size:
        failed.append("kept count beyond 2 %")
    if np.isfinite(ref["ate_m"]) and not got["ate_m"] <= ate_bar(ref["ate_m"]):
        failed.append("ATE above max(1.25 x JAX's, JAX's + 5 mm)")
    report["ate_bar_m"] = ate_bar(ref["ate_m"]) if np.isfinite(ref["ate_m"]) else None
    return report, failed


def tie_margins(scores, tol: float = K_RESPONSE_FILTER_TOLERANCE) -> dict:
    """Where a tier's (penalized) score grid stands against its tie line
    ``best - tol``: the candidates in the tie average, the lowest of them
    above the line and the closest outsider below it."""
    s = np.asarray(scores, np.float64).reshape(-1)
    line = s.max() - tol
    inside = s >= line
    return {"line": float(line), "ties": int(inside.sum()),
            "lowest_inside_above_line": float(s[inside].min() - line),
            "closest_outside_below_line": (float(line - s[~inside].max())
                                           if (~inside).any() else None)}


def classify_tier(ref_scores, got_scores, tol: float = K_RESPONSE_FILTER_TOLERANCE,
                  eps: float = 1e-5) -> dict:
    """Tell a tie flip from a fault on one tier's penalized score grids
    (the reference's and the port's, same candidates): the scores agree
    within ``eps``, and every candidate that is in one tie set and not in
    the other lies within ``eps`` of the reference's tie line. Returns the
    margins and ``kind``: "same" (equal tie sets), "tie_flip" or "fault"."""
    a = np.asarray(ref_scores, np.float64).reshape(-1)
    b = np.asarray(got_scores, np.float64).reshape(-1)
    d = float(np.abs(a - b).max())
    line_a, line_b = a.max() - tol, b.max() - tol
    flipped = (a >= line_a) != (b >= line_b)
    off_line = np.abs(a[flipped] - line_a)
    kind = "same"
    if d > eps or (off_line > eps).any():
        kind = "fault"
    elif flipped.any():
        kind = "tie_flip"
    return {"kind": kind, "scores_max_abs_diff": d, "flipped": int(flipped.sum()),
            "flipped_max_dist_to_line": float(off_line.max()) if flipped.any() else None,
            **tie_margins(a, tol)}
