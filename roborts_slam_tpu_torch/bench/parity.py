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
FREE_RMS_GAP = 5e-3                # m, a free run's gap to JAX where no truth
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


def compare_leg(got: dict, ref: dict, sha256: str | None) -> tuple[dict, list[str]]:
    """Hold one leg's record (``leg_record``) against JAX's (``ref``, from
    the fixture). Returns the report and the list of failed bars: the logs'
    hashes equal (``sha256`` None: a log that is not stored, not compared),
    the closure counts equal, the kept count within max(1, 2 %) of JAX's
    (below 50 kept scans 2 % is less than one), the ATE within
    ``ate_bar``."""
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
        "sha256_equal": sha256 is None or sha256 == ref["sha256"],
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
    if abs(kp.size - kj.size) > max(1.0, 0.02 * kj.size):
        failed.append("kept count beyond 2 %")
    if np.isfinite(ref["ate_m"]) and not got["ate_m"] <= ate_bar(ref["ate_m"]):
        failed.append("ATE above max(1.25 x JAX's, JAX's + 5 mm)")
    report["ate_bar_m"] = ate_bar(ref["ate_m"]) if np.isfinite(ref["ate_m"]) else None
    return report, failed


def run_record(engine, times, gt=None) -> dict:
    """``leg_record`` of a run over a log that is not one of ``LEGS``: the
    fed stamps ``times`` and, where the log has one, its truth ``gt`` (one
    pose per fed scan)."""
    return leg_record(engine, {"times": np.asarray(times, np.float64), "gt": gt},
                      port_ate if gt is not None else None)


def compare_free(got: dict, ref: dict) -> tuple[dict, list[str]]:
    """Hold a free run at a small size against JAX's on the same log, at
    the bars of a whole run at full width (``compare_leg``) plus: the same
    solve count, and where the log has no truth the RMS position gap on the
    shared kept scans at most ``FREE_RMS_GAP`` (m). The count of poses
    beyond ``POS_TOL`` / ``ANG_TOL``, the median and largest gap and the
    kept ids that differ are reported, not held: a free run at this size
    parts by tie flips wherever the last bits move a candidate across the
    tie line."""
    report, failed = compare_leg(got, ref, None)
    kj, kp = np.asarray(ref["kept_ids"]), np.asarray(got["kept_ids"])
    _, ij, ip = np.intersect1d(kj, kp, return_indices=True)
    d = (np.asarray(got["poses"], np.float64)[ip, :2]
         - np.asarray(ref["poses"], np.float64)[ij, :2])
    rms = float(np.sqrt(np.mean(np.sum(d * d, 1)))) if ip.size else float("inf")
    report.update(rms_gap_m=rms,
                  kept_ids_only_jax=np.setdiff1d(kj, kp).tolist(),
                  kept_ids_only_port=np.setdiff1d(kp, kj).tolist())
    if got["solves"] != ref["solves"]:
        failed.append("solve count")
    if not np.isfinite(ref["ate_m"]) and not rms <= FREE_RMS_GAP:
        failed.append("RMS gap to JAX above 5 mm")
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


def edge_flips(spec, params, offset, points, n_valid: int, pose, grid_ref, grid_got,
               in_map: bool = False) -> dict:
    """Where a tier's two score grids differ on the same input: for each
    candidate whose scores differ beyond 1e-5, the nearest approach of one
    of its samples' cell coordinates ``r + x + 0.5`` (the port's) to a cell
    edge, where ``floor`` switches cells. A sample that close to an edge
    lands in either cell by the last bits of its rotation (the packages'
    cos, sin and multiply-adds round differently). If every differing
    candidate has a sample within 1e-3 cells of an edge, the grids differ
    by rounding at cell edges: ``kind`` "cell_edge_flip". ``spec`` /
    ``params`` / ``offset``: the port's map spec, tier parameters and map
    offset; ``pose`` the tier's centre in world coordinates (``in_map``:
    in map cells)."""
    import torch

    from ..models.grid_map import world_to_map_pose
    from ..ops.correlative import candidate_grid

    c = torch.as_tensor(pose)
    if not in_map:
        c = world_to_map_pose(torch.as_tensor(offset), spec.inv_res, c)
    g = candidate_grid(spec, params, torch.as_tensor(points), n_valid, c)
    sv = g.svalid.numpy()[None, :, None]
    dist = []
    for r, v in ((g.rx, g.xs), (g.ry, g.ys)):
        u = (r[:, :, None] + v[None, None, :] + 0.5).numpy().astype(np.float64)   # (A, S, N)
        d = np.abs(u - np.round(u))
        dist.append(np.where(sv, d, np.inf).min(1))                              # (A, N)
    near = np.minimum(dist[0][:, :, None], dist[1][:, None, :])                  # (A, Nx, Ny)
    differ = np.abs(np.asarray(grid_ref, np.float64) - np.asarray(grid_got)) > 1e-5
    need = float(near[differ].max()) if differ.any() else 0.0
    return {"candidates_differing": int(differ.sum()),
            "edge_dist_of_their_closest_sample_max_cells": need,
            **({"kind": "cell_edge_flip"} if need <= 1e-3 else {})}


# ---- one step carried: the port's step from the reference's state ----

STEP_POS_TOL = STEP_ANG_TOL = 1e-5   # m, rad: a step's pose (about 5 f32 steps here)
STEP_SCORE_TOL = 1e-5                # a step's score
STEP_COV_RTOL = 1e-3                 # the covariance's positional block, relative
SOLVE_POSE_TOL = 1e-3                # m, rad: the store's poses after a solve (SPA tests)
TIE_FLIP_CAP = 3                     # tie flips a run may have
MAP_PLANES = ("pub_hits", "pub_passes", "coarse_probs", "fine_probs")


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def counts(engine) -> dict:
    """What says whether a step rebuilt maps: solves, recenters, the pub
    map's shape."""
    return {"solves": int(engine.backend.num_solves),
            "recenters": int(getattr(engine.diag, "recenters", 0)),
            "pub_shape": tuple(engine.state.pub.hits.shape)}


def observe(engine, kept: bool, summary) -> dict:
    """What one step of ``engine`` (either package's: the attribute names
    are shared) leaves, as NumPy: whether the scan was kept, the step's
    packed summary (None: the move gate dropped the scan before any step),
    the graph's edges, the closure count, ``counts``, the store's poses and
    the four map planes."""
    st = engine.state
    return {"kept": bool(kept),
            "summary": None if summary is None else np.asarray(summary, np.float64),
            "edges": [(int(e.source), int(e.target)) for e in engine.backend.graph.edges],
            "closures": int(engine.backend.num_loop_closures), **counts(engine),
            "poses": (np.asarray(engine.store.poses_array(), np.float64)
                      if len(engine.store) else np.zeros((0, 3))),
            "maps": {"pub_hits": _np(st.pub.hits).copy(), "pub_passes": _np(st.pub.passes).copy(),
                     "coarse_probs": _np(st.coarse.probs).copy(),
                     "fine_probs": _np(st.fine.probs).copy()},
            "offsets": {"pub_hits": _np(st.pub.offset).copy(),
                        "pub_passes": _np(st.pub.offset).copy(),
                        "coarse_probs": _np(st.coarse.offset).copy(),
                        "fine_probs": _np(st.fine.offset).copy()}}


def map_flip_cells(spec, offset, points, mask, pose_a, pose_b, half=None) -> tuple:
    """The cells of one map plane whose update the rounding of the pose
    decides, between two poses (world, float): a beam whose endpoint cell
    (the nearest cell, ``floor(x + 0.5)``) differs between the poses names
    every cell its update touches at either pose — its ray and endpoint on
    the pub map (``half`` None: the carve is an integer walk between the
    sensor's cell and the endpoint's, so no other beam's cells move), its
    footprint of ``half`` cells round the endpoint on a scan-match map; a
    sensor cell that differs names every beam. Returns the (H, W) bool
    image of named cells, the number of beams that flipped and the largest
    distance, in cells, of a flipped endpoint's coordinate from the cell
    edge it crossed (within the pose gap's reach of one where the poses
    are close)."""
    import torch

    from ..models.grid_map import world_to_map_pose
    from ..ops.raster import _scan_cells, mark_image_plain
    from ..utils.geometry import transform_points

    pts = torch.as_tensor(np.asarray(points, np.float32))
    msk = torch.as_tensor(np.asarray(mask, bool))
    off = torch.as_tensor(np.asarray(offset, np.float32))
    (sa, ea, ma), (sb, eb, mb) = (
        _scan_cells(spec.inv_res, off, pts, msk, torch.as_tensor(np.asarray(p, np.float32)))
        for p in (pose_a, pose_b))
    flipped = (ea != eb).any(-1) | (ma != mb)
    if (sa != sb).any():
        flipped = ma | mb
    H, W = spec.height, spec.width
    if half is None:
        named = ((mark_image_plain(sa, ea, ma & flipped, H, W) > 0)
                 | (mark_image_plain(sb, eb, mb & flipped, H, W) > 0)).numpy()
    else:
        named = np.zeros((H, W), bool)
        for e in (ea[flipped].numpy(), eb[flipped].numpy()):
            for x, y in e:
                named[max(y - half, 0):max(y + half + 1, 0),
                      max(x - half, 0):max(x + half + 1, 0)] = True
    pm = world_to_map_pose(off, spec.inv_res, torch.as_tensor(np.asarray(pose_a, np.float32)))
    u = transform_points(pm, pts * spec.inv_res).numpy().astype(np.float64) + 0.5
    d = np.abs(u - np.round(u)).min(-1)
    f = (flipped & msk).numpy()
    return named, int(flipped.sum()), float(d[f].max()) if f.any() else 0.0


def compare_observations(ref: dict, got: dict, ref_before: dict, got_before: dict,
                         scan=None, planes=None) -> dict:
    """Hold one carried step of the port (``got``, from ``observe``)
    against the reference's (``ref``) at the per-step bars: the same kept
    and gate decisions; the pose within ``STEP_POS_TOL`` / ``STEP_ANG_TOL``
    (``pose_bar``: missed, for the caller to classify), the score within
    ``STEP_SCORE_TOL``, the covariance's positional block within
    ``STEP_COV_RTOL``; the same edges, closure and solve decisions; after a
    solve the store's poses within ``SOLVE_POSE_TOL``; and where no solve
    moved the store's poses (``*_before`` are the engines' ``counts`` before
    the step), each map plane at the same offset and cell for cell but the
    cells ``map_flip_cells`` names between the two poses — also on a step
    that recentered the match maps or grew the pub map, whose rebuild reads
    the store's carried poses (``maps_rebuilt`` says such a step). ``scan``:
    the step's (points, mask); ``planes``: {plane: (port spec, offset after
    the step, footprint half-width or None for the pub map)}.
    Returns the row, with ``failed`` the bars missed but the pose's and
    the covariance's: ``pose_bar`` / ``cov_bar`` say whether those missed,
    for ``LockstepReport.add`` to classify."""
    row: dict = {"kept": [ref["kept"], got["kept"]], "failed": [], "pose_bar": False,
                 "cov_bar": False}
    fail = row["failed"].append
    if ref["kept"] != got["kept"]:
        fail("kept decision")
    sr, sg = ref["summary"], got["summary"]
    if (sr is None) != (sg is None):
        fail("move gate")
    elif sr is not None:
        gap = pose_gap(sg[None, :3], sr[None, :3])[0]
        cr, cg = sr[3:12].reshape(3, 3)[:2, :2], sg[3:12].reshape(3, 3)[:2, :2]
        scale = max(float(np.abs(cr).max()), 1e-12)
        row.update(pose_gap_m=float(gap[0]), pose_gap_rad=float(gap[1]),
                   score_diff=float(abs(sg[14] - sr[14])),
                   cov_xy_rel_diff=float(np.abs(cg - cr).max() / scale),
                   gates={"map_updated": [bool(sr[12] > 0.5), bool(sg[12] > 0.5)],
                          "pose_accepted": [bool(sr[13] > 0.5), bool(sg[13] > 0.5)]})
        if any(a != b for a, b in row["gates"].values()):
            fail("gate")
        row["pose_bar"] = bool(gap[0] > STEP_POS_TOL or gap[1] > STEP_ANG_TOL)
        if row["score_diff"] > STEP_SCORE_TOL:
            fail("score")
        row["cov_bar"] = bool(row["cov_xy_rel_diff"] > STEP_COV_RTOL)
    row["links"] = [len(ref["edges"]), len(got["edges"])]
    row["closures"] = [ref["closures"], got["closures"]]
    row["solves"] = [ref["solves"], got["solves"]]
    if ref["edges"] != got["edges"]:
        fail("links added")
    if ref["closures"] != got["closures"]:
        fail("closure decision")
    solved = [ref["solves"] > ref_before["solves"], got["solves"] > got_before["solves"]]
    if solved[0] != solved[1]:
        fail("solve decision")
    if ref["poses"].shape != got["poses"].shape:
        fail("store size")
    elif len(ref["poses"]):
        g = pose_gap(got["poses"], ref["poses"])
        row["store_pose_gap"] = [float(g[:, 0].max()), float(g[:, 1].max())]
        if any(solved) and max(row["store_pose_gap"]) > SOLVE_POSE_TOL:
            fail("poses after the solve")
    row["maps_rebuilt"] = bool(
        any(solved) or ref["recenters"] > ref_before["recenters"]
        or got["recenters"] > got_before["recenters"]
        or ref["pub_shape"] != ref_before["pub_shape"]
        or got["pub_shape"] != got_before["pub_shape"])
    row["maps"] = {}
    for plane in MAP_PLANES:
        a, b = ref["maps"][plane], got["maps"][plane]
        if a.shape != b.shape:
            row["maps"][plane] = f"shapes {list(b.shape)} / {list(a.shape)}"
            fail(f"{plane} shape")
            continue
        if "offsets" in ref and not np.array_equal(ref["offsets"][plane],
                                                   got["offsets"][plane]):
            fail(f"{plane} offset")
        differ = a != b
        row["maps"][plane] = {"differing": int(differ.sum())}
        if not differ.any() or any(solved):
            continue
        if planes is None or sr is None or sg is None:
            fail(f"{plane} cells")
            continue
        spec, offset, half = planes[plane]
        named, beams, edge = map_flip_cells(spec, offset, *scan, sr[:3], sg[:3], half)
        unnamed = int((differ & ~named).sum())
        row["maps"][plane].update(unnamed=unnamed, flipped_beams=beams,
                                  edge_dist_max_cells=edge)
        if unnamed:
            fail(f"{plane} cells")
    return row


def classify_top(ref_scores, got_scores, k: int = 20, eps: float = 1e-5) -> dict:
    """Tell a flip of the covariance's window from a fault on one tier's
    penalized score grids (the reference's and the port's, same
    candidates): the positional covariance weighs the ``k`` best candidates
    above min(best - 0.1, 0.5) (``positional_covariance``; the first by
    flat index among equal scores), so where two candidates' scores lie
    within the last bits of the k-th the window swaps them. ``kind``:
    "same" (equal windows), "top_flip" (every swapped candidate within
    ``eps`` of the reference's k-th score, the scores within ``eps``) or
    "fault"; with the margins."""
    def window(s):
        sel = s > min(s.max() - 0.1, 0.5)
        idx = np.flatnonzero(sel)
        top = idx[np.argsort(-s[idx], kind="stable")[:k]]
        return set(top.tolist()), (s[top].min() if top.size else -np.inf)

    a = np.asarray(ref_scores, np.float64).reshape(-1)
    b = np.asarray(got_scores, np.float64).reshape(-1)
    (ta, kth), (tb, _) = window(a), window(b)
    swapped = np.array(sorted(ta ^ tb), np.int64)
    d = float(np.abs(a - b).max())
    off = np.abs(a[swapped] - kth) if swapped.size else np.zeros(0)
    explained = d <= eps and (off <= eps).all()
    kind = "same" if not swapped.size else "top_flip" if explained else "fault"
    return {"kind": kind, "scores_max_abs_diff": d, "swapped": int(swapped.size),
            "swapped_max_dist_to_kth": float(off.max()) if off.size else None,
            "kth_score": float(kth)}


def classify_chain(ties: dict, tops: dict) -> dict:
    """The verdict on a step from its tiers in chain order (``ties``:
    ``classify_tier``'s, ``tops``: ``classify_top``'s, by tier name). The
    pose's is that of the first tier whose tie sets differ, the
    covariance's that of the first tier whose windows differ; each counts
    as a flip only where every tier before that one is "same" (for the
    covariance, in its tie sets too): a fault in an earlier tier is not
    excused by a flip in a later one. ``pose`` "tie_flip" / ``cov``
    "top_flip", else "fault"."""
    def first(by, flip, also=None):
        for n in by:
            if by[n]["kind"] != "same":
                return flip if by[n]["kind"] == flip else "fault"
            if also is not None and also[n]["kind"] != "same":
                return "fault"
        return "fault"
    return {"pose": first(ties, "tie_flip"), "cov": first(tops, "top_flip", ties)}


class LockstepReport:
    """The per-step rows of a lockstep run and its verdict: every step
    within the per-step bars, but at most ``TIE_FLIP_CAP`` steps whose pose
    or positional covariance alone missed its bar where the reference's own
    tiers name a flip at a discontinuity of the last bits: a tie flip for
    the pose (``classify_tier``: every score within 1e-5, the flipped
    candidates within 1e-5 of the line), a window flip for the covariance
    (``classify_top``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.rows: list[dict] = []

    def add(self, scan: int, row: dict, tie: dict | None = None) -> dict:
        """Record step ``scan``'s row (``compare_observations``). ``tie``:
        for a step whose pose or covariance missed its bar, the reference's
        verdict on it — ``pose`` / ``cov`` "tie_flip" / "top_flip" with the
        tiers' margins where each is such a flip."""
        row = dict(row, scan=scan, failed=list(row["failed"]))
        tie = tie or {}
        flipped = ((not row["pose_bar"] or tie.get("pose") == "tie_flip")
                   and (not row["cov_bar"] or tie.get("cov") == "top_flip"))
        if row["pose_bar"] or row["cov_bar"]:
            # the verdicts on the bars this step missed
            tie = {q: v for q, v in tie.items()
                   if not (q in ("pose", "tiers") and not row["pose_bar"])
                   and not (q in ("cov", "windows") and not row["cov_bar"])}
            if flipped:
                row["tie_flip"] = tie
            else:
                row["failed"] += (["pose"] if row["pose_bar"] else []) + \
                    (["covariance"] if row["cov_bar"] else [])
                row["not_a_tie_flip"] = tie
        self.rows.append(row)
        return row

    @property
    def tie_flips(self) -> list[dict]:
        return [r for r in self.rows if "tie_flip" in r]

    def failed(self) -> list[str]:
        out = [f"scan {r['scan']}: {', '.join(r['failed'])}" for r in self.rows if r["failed"]]
        if len(self.tie_flips) > TIE_FLIP_CAP:
            out.append(f"{len(self.tie_flips)} tie flips, more than {TIE_FLIP_CAP}")
        return out

    def summary(self) -> dict:
        stepped = [r for r in self.rows if "pose_gap_m" in r]
        big = lambda k: max((r[k] for r in stepped), default=0.0)
        return {"name": self.name, "steps": len(self.rows), "stepped": len(stepped),
                "max_pose_gap_m": big("pose_gap_m"), "max_pose_gap_rad": big("pose_gap_rad"),
                "max_score_diff": big("score_diff"),
                "max_cov_xy_rel_diff": big("cov_xy_rel_diff"),
                "tie_flips": [{"scan": r["scan"], "pose_gap_m": r["pose_gap_m"],
                               "pose_gap_rad": r["pose_gap_rad"], **r["tie_flip"]}
                              for r in self.tie_flips],
                "map_cells_differing": {p: sum(r["maps"][p]["differing"] for r in self.rows
                                               if isinstance(r["maps"].get(p), dict))
                                        for p in MAP_PLANES},
                "failed": self.failed()}
