"""The comparison that decides ``correct``: the program's steps held against
the plain reference (``reference/slamref``) on the steps the window ran.

The engine is a state machine whose runs part by tie flips (two equal
candidates of a correlative tier swap on the last bit), so two free runs of a
whole log cannot be held step for step. The reference therefore follows the
program from the program's own state, one step at a time:

- **sampled steps**: before a sampled ``process()`` call of the window the
  program's whole state is copied (``program_state``: maps, front-end
  scalars, scan store, pose graph, gating memory), after it what the step
  left (``observe``). After the window a reference engine is built in that
  state (``carry``) and takes the same raw scan (ranges, odometry, stamp):
  its own points, de-distortion, the three correlative tiers, the map check,
  the map update and carve, the fused chain match, the links, and any loop
  closure the call made. Its results are held against the program's
  (``compare_step``). The first scans of the first episode are always
  sampled: there the state is the empty start, so the start is checked by
  itself.
- **sampled closures**: before a sampled pose-graph solve the program's state
  is copied, after it the corrected poses and the rebuilt maps. The
  reference solves the same graph from the same poses (``solve_cost_excess``:
  how far above the reference's cost the program's solution lies;
  ``solve_pose_gap_m``) and, from the same state, rebuilds every map from the
  program's corrected poses (``rebuild_map_cells``).

A step whose pose or covariance departs where the reference's own tiers lie
within ``TIE_EPS`` of a tie line, of the covariance window's 20th score or
of a response threshold is a flip, not a fault: it is counted and excused
(the program's kernels sum in another order than the plain reference).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

TIE_EPS = 1e-5            # the margin within which the last bits may flip a decision
FLIP_CELLS = 1e-2         # cells: a tier whose best pose moves more under a centre shifted by
FLIP_RAD = 1e-4           # a few float32 spacings (or rad: its angle) lies on a cell edge
FLIP_COV = 1e-3           # relative: the same for the covariance's positional block
TOL = 1e-2                # the correlative match's tie tolerance (K_RESPONSE_FILTER_TOLERANCE)
MAP_PLANES = ("pub_hits", "pub_passes", "coarse_probs", "fine_probs")


# ---- the program's side: what is copied during the window ----

def _host(a):
    return a.detach().cpu().numpy().copy() if isinstance(a, torch.Tensor) else np.array(a)


def program_state(eng) -> dict:
    """The engine's whole state as NumPy copies, in the layout of its
    checkpoint plus what a checkpoint leaves out (the whole front-end state,
    the float64 host mirrors, map->odom, the move gate's memory)."""
    st, g, s = eng.store, eng.backend.graph, eng.state
    n, edges, hist = len(st), g.edges, eng._odom_history
    opt = lambda v: np.full(3, np.nan) if v is None else np.array(v, np.float64)
    t64 = lambda v: np.float64(np.nan if v is None else v)
    state = {"pub_hits": _host(s.pub.hits), "pub_passes": _host(s.pub.passes),
             "pub_offset": _host(s.pub.offset), "coarse_probs": _host(s.coarse.probs),
             "coarse_offset": _host(s.coarse.offset), "fine_probs": _host(s.fine.probs),
             "fine_offset": _host(s.fine.offset), "pose": _host(s.pose),
             "last_map_update_pose": _host(s.last_map_update_pose),
             "map_penalize_times": _host(s.map_penalize_times),
             "scan_index": _host(s.scan_index), "last_kept_odom": _host(s.last_kept_odom),
             "last_step_time": _host(s.last_step_time)}
    return dict(
        config_json=np.frombuffer(json.dumps(dataclasses.asdict(eng.config)).encode(), np.uint8),
        laser_params=eng.laser.to_array(),
        odom_history_t=np.array([h[0] for h in hist]),
        odom_history_p=np.stack([h[1] for h in hist]) if hist else np.zeros((0, 3)),
        world_size=np.float64(eng.world_size),
        store_points=(np.stack(st._points) if n
                      else np.zeros((0, st.max_points, 2), np.float32)),
        store_masks=np.stack(st._masks) if n else np.zeros((0, st.max_points), bool),
        store_n_valid=np.asarray(st._n_valid, np.int64),
        store_poses=st.poses_array() if n else np.zeros((0, 3)),
        store_odoms=np.asarray(st.odoms) if n else np.zeros((0, 3)),
        store_times=np.asarray(st.times),
        store_running_ids=np.asarray(st.running_ids, np.int64),
        graph_num_vertices=np.int64(g.num_vertices),
        edge_st=np.array([[e.source, e.target] for e in edges], np.int64).reshape(-1, 2),
        edge_rel=np.stack([e.rel_pose for e in edges]) if edges else np.zeros((0, 3)),
        edge_info=np.stack([e.information for e in edges]) if edges else np.zeros((0, 3, 3)),
        backend_counters=np.array([eng.backend.num_loop_closures, eng.backend.num_links],
                                  np.int64),
        **{k: state[k] for k in ("pub_hits", "pub_passes", "pub_offset", "coarse_probs",
                                 "coarse_offset", "fine_probs", "fine_offset")},
        state_pose=state["pose"], state_last_map_update_pose=state["last_map_update_pose"],
        state_map_penalize_times=state["map_penalize_times"],
        state_scan_index=state["scan_index"],
        trajectory=eng.trajectory_array() if eng.trajectory else np.zeros((0, 4)),
        last_kept_odom=opt(eng._last_kept_odom),
        last_process_time=t64(eng._last_process_time),
        dev_time_origin=t64(eng._dev_time_origin),
        diag=np.array([eng.diag.scans_in, eng.diag.scans_processed,
                       eng.diag.scans_dropped_gate, eng.diag.scans_dropped_move,
                       eng.diag.loop_closures], np.int64),
        state=state,
        host_pub_offset=np.array(eng._host_pub_off, np.float64),
        host_coarse_offset=np.array(eng._host_coarse_off, np.float64),
        host_fine_offset=np.array(eng._host_fine_off, np.float64),
        host_pose=np.array(eng._host_pose, np.float64),
        map_to_odom=np.array(eng._map_to_odom, np.float64),
        prev_process_time=t64(eng._prev_process_time),
        move_ref_odom=opt(eng._move_ref_odom))


def counts(eng) -> dict:
    """What says whether a step rebuilt maps or ran a chain batch: solves,
    recenters, the pub map's shape, chain batches (fused into a step or
    separate)."""
    return {"solves": int(eng.backend.num_solves), "recenters": int(eng.diag.recenters),
            "pub_shape": tuple(eng.state.pub.hits.shape),
            "chains": int(eng.diag.fused_steps + eng.backend.num_chain_dispatches)}


def observe(eng, kept: bool, summary) -> dict:
    """What one step of ``eng`` (the program's or the reference's) left, as
    NumPy: the kept decision, the packed summary (None: the move gate
    dropped the scan), the graph's edges with their measured relative poses,
    the closure count, ``counts``, the store's poses and the four map planes
    with their offsets."""
    st = eng.state
    edges = eng.backend.graph.edges
    return {"kept": bool(kept),
            "summary": None if summary is None else np.asarray(summary, np.float64),
            "edges": [(int(e.source), int(e.target)) for e in edges],
            "edge_rel": (np.stack([e.rel_pose for e in edges]) if edges
                         else np.zeros((0, 3))),
            "closures": int(eng.backend.num_loop_closures), **counts(eng),
            "poses": (np.asarray(eng.store.poses_array(), np.float64)
                      if len(eng.store) else np.zeros((0, 3))),
            "maps": {"pub_hits": _host(st.pub.hits), "pub_passes": _host(st.pub.passes),
                     "coarse_probs": _host(st.coarse.probs),
                     "fine_probs": _host(st.fine.probs)},
            "offsets": {"pub_hits": _host(st.pub.offset), "pub_passes": _host(st.pub.offset),
                        "coarse_probs": _host(st.coarse.offset),
                        "fine_probs": _host(st.fine.offset)}}


# ---- the reference's side ----

def carry(z: dict, device):
    """A reference engine on ``device`` in the state ``program_state`` took:
    restored as from a checkpoint, then the whole front-end state, the host
    mirrors and the move gate's memory set from the copy. Its steps are
    eager."""
    from slamref.convert import state_from_jax
    from slamref.io.checkpoint import restore_checkpoint

    ref = restore_checkpoint(z, device=device)
    ref.state = state_from_jax(z["state"], ref.device)
    ref._host_pose = z["host_pose"].copy()
    for name in ("pub", "coarse", "fine"):
        setattr(ref, f"_host_{name}_off", z[f"host_{name}_offset"].copy())
    t = float(z["prev_process_time"])
    ref._prev_process_time = None if np.isnan(t) else t
    ref._move_ref_odom = (None if np.isnan(z["move_ref_odom"]).any()
                          else z["move_ref_odom"].copy())
    origin = float(z["dev_time_origin"])
    ref._dev_time_origin = None if np.isnan(origin) else origin
    ref._publish_pub_arrays()
    return ref


class _Tap:
    """While entered: the reference's step summary and the scan it used
    (``seen``: points and mask), and every tier match it ran (its score
    grid, response and threshold)."""

    def __init__(self, shift: bool = True):
        self.shift = shift

    def __enter__(self):
        from slamref.engine import SlamEngine
        from slamref.ops import correlative

        self.summary, self.seen = None, None
        self._cls, self._corr = SlamEngine, correlative
        self._orig = SlamEngine._process_gated
        orig, tap = self._orig, self

        def run(eng, points, mask, n_valid, odom, t):
            eng.last_summary = None
            out = orig(eng, points, mask, n_valid, odom, t)
            if eng.last_summary is not None:
                tap.summary = np.asarray(eng.last_summary, np.float64)
                tap.seen = (np.array(points, np.float32), np.array(mask, bool))
            return out

        SlamEngine._process_gated = run
        correlative.TAP.update(on=True, shift=self.shift, tiers=[])
        return self

    def __exit__(self, *exc):
        self._cls._process_gated = self._orig
        self.tiers = self._corr.TAP["tiers"]
        self._corr.TAP["on"], self._corr.TAP["tiers"] = False, []


def decision_margins(tiers: list) -> dict:
    """How near a flip of its last bits, or of a cell edge, the reference's
    decisions lay, over every tier match and every map of a batch:
    ``pose`` the least distance of a candidate from the tie line (best -
    ``TOL``) or of a response from its threshold; ``cov`` the least margin
    of the positional covariance's choice of its candidates
    (``correlative._positional_cut``); and how far the best pose
    (``shift_cells``, ``shift_rad``) and the covariance (``shift_cov``) move
    when the tier's centre is shifted by a few float32 spacings
    (``correlative._shifted``). The step's first tier is left out of the
    shift: its centre is the odometry prediction, which both sides compute
    alike; every later tier is centred on an earlier tier's tie-averaged
    pose, whose last bits follow the sums'."""
    out = {"pose": np.inf, "cov": np.inf, "shift_cells": 0.0, "shift_rad": 0.0,
           "shift_cov": 0.0}
    for i, t in enumerate(tiers):
        s = t["scores"].detach().double()
        flat = s.reshape(-1, s.shape[-3] * s.shape[-2] * s.shape[-1])
        best = flat.max(-1, keepdim=True).values
        out["pose"] = min(out["pose"], float((flat - (best - TOL)).abs().min()))
        r = t["response"].detach().double().reshape(-1)
        out["pose"] = min(out["pose"], float((r - t["threshold"]).abs().min()))
        out["cov"] = min(out["cov"], t["cut_margin"])
        if i:
            out["shift_cells"] = max(out["shift_cells"], t["shift_pose_cells"])
            out["shift_rad"] = max(out["shift_rad"], t["shift_pose_rad"])
            out["shift_cov"] = max(out["shift_cov"], t["shift_cov_rel"])
    return out


def ref_step(z: dict, scan: tuple, device, lower: bool = False):
    """The reference's step from the program's state ``z`` on the raw
    ``scan`` (ranges, odometry, stamp). Returns (``observe`` of it, the
    ``counts`` before it, the scan it used, its ``decision_margins``)."""
    from slamref.plain import lower_precision

    with lower_precision(lower):
        ref = carry(z, device)
        before = counts(ref)
        with _Tap(shift=not lower) as tap:
            kept = ref.process(*scan)
        obs = observe(ref, kept, tap.summary)
        margin = None if lower else decision_margins(tap.tiers)
    del ref
    return obs, before, tap.seen, margin


def pose_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 2) per pose: position gap (m, the larger axis) and wrapped angle
    gap (rad)."""
    pos = np.abs(np.asarray(a, np.float64)[:, :2] - np.asarray(b, np.float64)[:, :2]).max(1)
    d = np.asarray(a, np.float64)[:, 2] - np.asarray(b, np.float64)[:, 2]
    return np.stack([pos, np.abs(np.arctan2(np.sin(d), np.cos(d)))], 1)


def map_flip_cells(spec, offset, points, mask, pose_a, pose_b, half=None) -> np.ndarray:
    """The cells of one map plane whose update the rounding of the pose
    decides between two poses: every cell a beam touches at either pose
    where the beam's endpoint cell differs between them (its ray on the pub
    map, ``half`` None; its blur footprint of ``half`` cells on a
    scan-match map); every beam's where the sensor's cell differs."""
    from slamref.ops.raster import _scan_cells, mark_image_plain

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
        return ((mark_image_plain(sa, ea, ma & flipped, H, W) > 0)
                | (mark_image_plain(sb, eb, mb & flipped, H, W) > 0)).numpy()
    named = np.zeros((H, W), bool)
    for e in (ea[flipped].numpy(), eb[flipped].numpy()):
        for x, y in e:
            named[max(y - half, 0):max(y + half + 1, 0),
                  max(x - half, 0):max(x + half + 1, 0)] = True
    return named


def _planes(z: dict, ref_obs: dict):
    """{plane: (spec, offset after the step, footprint half-width or None)}
    of the reference engine's maps, for ``map_flip_cells``."""
    from slamref.config import SlamConfig
    from slamref.frontend.processor import FrontendSpec
    import dataclasses as dc

    cfg = SlamConfig(**json.loads(bytes(z["config_json"]).decode()))
    laser_range = float(z["laser_params"][3])
    fs = FrontendSpec.from_config(cfg, laser_range, float(z["world_size"]))
    ph, pw = ref_obs["maps"]["pub_hits"].shape
    pub = (fs.pub_spec if (ph, pw) == (fs.pub_spec.height, fs.pub_spec.width)
           else dc.replace(fs.pub_spec, height=ph, width=pw))
    half = lambda spec, blur: spec.kernel_half if blur else 0
    off = ref_obs["offsets"]
    return {"pub_hits": (pub, off["pub_hits"], None),
            "pub_passes": (pub, off["pub_passes"], None),
            "coarse_probs": (fs.coarse_spec, off["coarse_probs"],
                             half(fs.coarse_spec, cfg.coarse_map_use_blur)),
            "fine_probs": (fs.fine_spec, off["fine_probs"],
                           half(fs.fine_spec, cfg.fine_map_use_blur))}


def compare_step(z: dict, got: dict, got_before: dict, ref: dict, ref_before: dict,
                 seen, margins: dict) -> dict:
    """One sampled step of the program (``got``) held against the
    reference's (``ref``), both from the state ``z``. Returns the step's
    numbers: ``decisions`` (kept, move gate, map-update and pose gates,
    edges added, closure and solve decisions that differ), ``pose_gap_m`` /
    ``pose_gap_rad`` and ``edge_gap_m`` (the added edges' measured relative
    poses), 0 where ``flip``: the reference's decisions lay within
    ``TIE_EPS`` of a flip of the last bits, or its best pose moved under a
    centre shifted by a few float32 spacings (``decision_margins``);
    ``cov_rel_gap``, 0 where ``cov_flip`` (the same of the covariance);
    ``score_gap``; after a solve
    ``solve_pose_gap_m`` (the store's poses), and ``map_cells``: the cells of
    the four planes that differ and that no pose rounding explains (a step
    that solved compares no map: the closure check does)."""
    row = {"chain": got["chains"] > got_before["chains"], "decisions": 0, "pose_gap_m": 0.0, "pose_gap_rad": 0.0, "cov_rel_gap": 0.0,
           "score_gap": 0.0, "edge_gap_m": 0.0, "map_cells": 0, "flip": False,
           "cov_flip": False, "margins": margins, "what": []}
    what = row["what"].append
    if ref["kept"] != got["kept"]:
        what("kept")
    sr, sg = ref["summary"], got["summary"]
    if (sr is None) != (sg is None):
        what("move gate")
    elif sr is not None:
        gap = pose_gap(sg[None, :3], sr[None, :3])[0]
        cr, cg = sr[3:12].reshape(3, 3)[:2, :2], sg[3:12].reshape(3, 3)[:2, :2]
        cov = float(np.abs(cg - cr).max() / max(float(np.abs(cr).max()), 1e-12))
        row["score_gap"] = float(abs(sg[14] - sr[14]))
        if bool(sr[12] > 0.5) != bool(sg[12] > 0.5):
            what("map-update gate")
        if bool(sr[13] > 0.5) != bool(sg[13] > 0.5):
            what("pose gate")
        row["flip"] = bool(margins["pose"] <= TIE_EPS or margins["shift_cells"] > FLIP_CELLS
                           or margins["shift_rad"] > FLIP_RAD)
        row["cov_flip"] = bool(row["flip"] or margins["cov"] <= TIE_EPS
                               or margins["shift_cov"] > FLIP_COV)
        if not row["flip"]:
            row.update(pose_gap_m=float(gap[0]), pose_gap_rad=float(gap[1]))
            if not row["cov_flip"]:
                row["cov_rel_gap"] = cov
    if ref["edges"] != got["edges"]:
        what("edges")
    elif not row["flip"]:
        new = len(z["edge_st"])
        if len(ref["edges"]) > new:
            row["edge_gap_m"] = float(pose_gap(got["edge_rel"][new:], ref["edge_rel"][new:])[:, 0].max())
    if ref["closures"] != got["closures"]:
        what("closure")
    solved = [ref["solves"] > ref_before["solves"], got["solves"] > got_before["solves"]]
    if solved[0] != solved[1]:
        what("solve")
    if ref["poses"].shape != got["poses"].shape:
        what("store size")
    elif any(solved) and len(ref["poses"]):
        row["solve_pose_gap_m"] = float(pose_gap(got["poses"], ref["poses"])[:, 0].max())
    row["decisions"] = len(row["what"])
    if not any(solved) and not row["what"]:
        planes = _planes(z, ref)
        for plane in MAP_PLANES:
            a, b = ref["maps"][plane], got["maps"][plane]
            if a.shape != b.shape or not np.array_equal(ref["offsets"][plane],
                                                        got["offsets"][plane]):
                row["map_cells"] += int(max(a.size, b.size))
                continue
            differ = a != b
            if not differ.any():
                continue
            if sr is None or seen is None:
                row["map_cells"] += int(differ.sum())
                continue
            spec, offset, half = planes[plane]
            named = map_flip_cells(spec, offset, *seen, sr[:3], sg[:3], half)
            row["map_cells"] += int((differ & ~named).sum())
    return row


def check_closure(rec: dict, device, lower: bool = False) -> dict:
    """One sampled solve of the program, ``rec``: its state before the solve
    (``z``), the poses it corrected to (``corrected``) and the maps after
    the rebuild (``maps``, ``offsets``). The reference solves the same graph
    from the same poses (``solve_cost_excess``, ``cost_excess``; and the
    largest position and angle gaps, ``solve_pose_gap_m`` and
    ``solve_angle_gap_rad``), then, from the same state, installs the
    program's corrected poses and rebuilds every map (``rebuild_map_cells``:
    cells of the four planes that differ)."""
    from slamref.plain import lower_precision

    z = rec["z"]
    with lower_precision(lower):
        ref = carry(z, device)
        got = {}
        ref.backend.on_corrections = lambda c: got.setdefault("c", c)
        ref.backend._solve_and_correct()
        gap = pose_gap(got["c"], rec["corrected"])
        # the control's solution is the one judged, against the program's
        # in the reference's place
        excess = (cost_excess(ref.backend.graph, got["c"], rec["corrected"]) if lower
                  else cost_excess(ref.backend.graph, rec["corrected"], got["c"]))
        del ref
        ref = carry(z, device)
        ref._apply_corrections(np.asarray(rec["corrected"], np.float64))
        obs = observe(ref, True, None)
        del ref
    cells = 0
    for plane in MAP_PLANES:
        a, b = obs["maps"][plane], rec["maps"][plane]
        if a.shape != b.shape or not np.array_equal(obs["offsets"][plane], rec["offsets"][plane]):
            cells += int(max(a.size, b.size))
        else:
            cells += int((a != b).sum())
    return {"nodes": int(len(rec["corrected"])), "solve_cost_excess": excess,
            "solve_pose_gap_m": float(gap[:, 0].max()),
            "solve_angle_gap_rad": float(gap[:, 1].max()), "rebuild_map_cells": cells}


def cost_excess(graph, got: np.ndarray, ref: np.ndarray) -> float:
    """How far the solved poses ``got`` lie above the reference's solution
    ``ref`` in the pose graph's cost (float64): cost(got) / cost(ref) - 1,
    0 where ``got`` is no worse. The masked solve sums with atomics on the
    card, so its LM steps, and where in the cost's flat valley it stops,
    move from run to run; the cost it reaches does not."""
    from slamref.backend.spa import graph_cost

    data = graph.as_solver_data(np.asarray(ref, np.float64), "cpu")
    data = data._replace(**{k: getattr(data, k).double()
                            for k in ("poses", "edge_rel", "edge_info")})
    pn = data.poses.shape[0]

    def cost(p):
        full = torch.zeros((pn, 3), dtype=torch.float64)
        full[:len(p)] = torch.as_tensor(np.asarray(p, np.float64))
        return float(graph_cost(full, data))

    c_ref = cost(ref)
    return max(cost(got) / c_ref - 1.0, 0.0) if c_ref > 0 else 0.0


def summarize(steps: list, closures: list) -> dict:
    """The run's compared numbers from its checked steps and closures."""
    big = lambda rows, k, zero=0.0: max((r.get(k, zero) for r in rows), default=zero)
    return {"steps_checked": len(steps), "chain_steps_checked": sum(r["chain"] for r in steps),
            "closures_checked": len(closures),
            "step_flips": sum(r["flip"] for r in steps),
            "step_cov_flips": sum(r["cov_flip"] for r in steps),
            "step_decisions": sum(r["decisions"] for r in steps),
            "step_pose_gap_m": big(steps, "pose_gap_m"),
            "step_edge_gap_m": big(steps, "edge_gap_m"),
            "step_score_gap": big(steps, "score_gap"),
            "step_cov_rel_gap": big(steps, "cov_rel_gap"),
            "step_map_cells": sum(r["map_cells"] for r in steps),
            "solve_pose_gap_m": max(big(closures, "solve_pose_gap_m"),
                                    big(steps, "solve_pose_gap_m")),
            "solve_cost_excess": big(closures, "solve_cost_excess"),
            "rebuild_map_cells": sum(r["rebuild_map_cells"] for r in closures)}


def verdict(numbers: dict, failed: int, workload: dict) -> tuple[bool, dict]:
    """Whether a run is correct, and each number it was judged by: every
    number of the cell's ``limits`` at or under its limit, and as many
    steps, steps that ran a chain batch and closures checked as the cell
    samples (at least one each that it asks for); no episode failed."""
    judged = {k: {"value": numbers[k], "limit": v} for k, v in workload["limits"].items()}
    s = workload["samples"]
    need = {"steps_checked": 1, "chain_steps_checked": int(s.get("chain_steps", 0) > 0),
            "closures_checked": int(s.get("closures", 0) > 0)}
    for k, least in need.items():
        if least:
            judged[k] = {"value": numbers[k], "at_least": least}
    judged["failed_episodes"] = {"value": failed, "limit": 0}
    ok = all(v["value"] <= v["limit"] if "limit" in v else v["value"] >= v["at_least"]
             for v in judged.values())
    return ok, judged
