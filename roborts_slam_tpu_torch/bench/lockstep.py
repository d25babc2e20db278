"""One engine held against a reference engine one carried step at a time.

Before each fed scan the reference engine's whole state — front-end maps
and scalars, scan store, pose graph, gating memory, the float64 host
offsets of the maps and the map->odom transform — is carried into a fresh
port engine (``engine_arrays``, ``carry``); both take the same scan and the
port's step is held against the reference's at ``parity``'s per-step bars
(``parity.compare_observations``). A step whose pose or covariance alone
misses its bar is handed to a classifier that tells a flip at a
discontinuity of the last bits (the tie line, the covariance's window, a
cell edge) from a fault.

The reference is the JAX package's engine in the tests
(``tests/_torch_lockstep.py`` supplies its tap and classifier) and the
port's plain path on the CPU in ``chip_smoke.py``'s
``kernel_vs_plain_lockstep``, where the carried engine runs on the card
(``PortTap`` and ``classify_by_grids`` here). Nothing here imports JAX:
``engine_arrays`` reads the attribute names both packages' engines share.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from . import parity


def state_arrays(state) -> dict:
    """A front-end state (either package's) as NumPy copies by
    ``convert.STATE_KEYS`` name, with ``last_step_time``."""
    to = lambda a: (a.detach().cpu().numpy().copy() if isinstance(a, torch.Tensor)
                    else np.array(a))       # a copy: the port's step writes in place
    return {"pub_hits": to(state.pub.hits), "pub_passes": to(state.pub.passes),
            "pub_offset": to(state.pub.offset),
            "coarse_probs": to(state.coarse.probs),
            "coarse_offset": to(state.coarse.offset),
            "fine_probs": to(state.fine.probs), "fine_offset": to(state.fine.offset),
            "pose": to(state.pose), "last_map_update_pose": to(state.last_map_update_pose),
            "map_penalize_times": to(state.map_penalize_times),
            "scan_index": to(state.scan_index), "last_kept_odom": to(state.last_kept_odom),
            "last_step_time": to(state.last_step_time)}


def engine_arrays(eng) -> dict:
    """An engine's whole state (either package's) as the arrays of its
    checkpoint (the two packages' ``io/checkpoint.py`` keys, taken without
    the checkpoint's ``finish()``), plus what the checkpoint leaves out: the
    whole front-end state (``state``), the float64 host offsets of the three
    maps and the host pose, the map->odom transform and the move gate's
    memory, all from the engine object."""
    st, g = eng.store, eng.backend.graph
    n, edges, hist = len(st), g.edges, eng._odom_history
    opt = lambda v: np.full(3, np.nan) if v is None else np.array(v, np.float64)
    t64 = lambda v: np.float64(np.nan if v is None else v)
    s = state_arrays(eng.state)
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
        **{k: s[k] for k in ("pub_hits", "pub_passes", "pub_offset", "coarse_probs",
                             "coarse_offset", "fine_probs", "fine_offset")},
        state_pose=s["pose"], state_last_map_update_pose=s["last_map_update_pose"],
        state_map_penalize_times=s["map_penalize_times"],
        state_scan_index=s["scan_index"],
        trajectory=eng.trajectory_array() if eng.trajectory else np.zeros((0, 4)),
        last_kept_odom=opt(eng._last_kept_odom),
        last_process_time=t64(eng._last_process_time),
        dev_time_origin=t64(getattr(eng, "_dev_time_origin", None)),
        diag=np.array([eng.diag.scans_in, eng.diag.scans_processed, eng.diag.scans_dropped_gate,
                       eng.diag.scans_dropped_move, eng.diag.loop_closures], np.int64),
        # beyond the checkpoint
        state=s,
        host_pub_offset=np.array(eng._host_pub_off, np.float64),
        host_coarse_offset=np.array(eng._host_coarse_off, np.float64),
        host_fine_offset=np.array(eng._host_fine_off, np.float64),
        host_pose=np.array(eng._host_pose, np.float64),
        map_to_odom=np.array(eng._map_to_odom, np.float64),
        prev_process_time=t64(eng._prev_process_time),
        move_ref_odom=opt(eng._move_ref_odom))


def carry(z: dict, device="cpu", **engine_kwargs):
    """A port engine on ``device`` in the state ``engine_arrays`` took:
    restored as from a checkpoint (``io/checkpoint.py::restore_checkpoint``),
    then the whole front-end state, the host offsets and pose, map->odom,
    the move gate's memory and the device clock's origin set from the
    engine's own values."""
    from ..convert import state_from_jax
    from ..io.checkpoint import restore_checkpoint

    te = restore_checkpoint(z, device=device, **engine_kwargs)
    te.state = state_from_jax(z["state"], te.device)
    te._host_pose = z["host_pose"].copy()
    for name in ("pub", "coarse", "fine"):
        setattr(te, f"_host_{name}_off", z[f"host_{name}_offset"].copy())
    te._map_to_odom = z["map_to_odom"].copy()
    t = float(z["prev_process_time"])
    te._prev_process_time = None if np.isnan(t) else t
    te._move_ref_odom = None if np.isnan(z["move_ref_odom"]).any() else z["move_ref_odom"].copy()
    origin = float(z["dev_time_origin"])      # NaN where the reference set none
    te._dev_time_origin = None if np.isnan(origin) else origin
    te._publish_pub_arrays()
    return te


class PortTap:
    """While entered, records the port engine's front-end step (blocking,
    windowed or fused): its packed summary as ``summary``, and the scan
    it took as ``seen`` (points, mask, n_valid: NumPy)."""

    NAMES = ("frontend_step", "frontend_step_windowed", "fused_frontend_chain_step")

    def __enter__(self):
        from .. import engine as tengine

        self.summary, self.seen, self._mod = None, None, tengine
        self._orig = {n: getattr(tengine, n) for n in self.NAMES}

        def tapped(name, fn):
            at = 3 if name == "fused_frontend_chain_step" else -4   # the scan's points

            def run(*args, **kw):
                out = fn(*args, **kw)
                s = out[2] if len(out) == 3 else out[1].summary
                self.summary = np.asarray(s, np.float64)
                p, m, n = args[at:at + 3] if at > 0 else args[at:-1]
                self.seen = {"points": p.detach().cpu().numpy(), "mask": m.detach().cpu().numpy(),
                             "n_valid": int(n)}
                return out
            return run

        for n, fn in self._orig.items():
            setattr(tengine, n, tapped(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._mod, n, fn)


class GridTap:
    """While entered, records every correlative tier match the port runs:
    its spec, parameters, map offset, scan, centre (map cells) and
    penalized score grid, as NumPy, in ``tiers`` (the front-end step's three
    come first; a chain batch's follow, with a leading batch dimension)."""

    def __enter__(self):
        from ..ops import correlative as tc

        self.tiers, self._mod = [], tc
        self._orig = (tc.score_candidates, tc.find_best_candidate)
        score, best = self._orig

        def on_score(spec, params, probs, offset, points, mask, n_valid, center, **kw):
            self.tiers.append({"spec": spec, "params": params, "offset": _host(offset),
                               "points": _host(points), "n_valid": int(n_valid),
                               "center": _host(center)})
            return score(spec, params, probs, offset, points, mask, n_valid, center, **kw)

        def on_best(scores, angles, xs, ys):
            self.tiers[-1]["grid"] = _host(scores)
            return best(scores, angles, xs, ys)

        tc.score_candidates, tc.find_best_candidate = on_score, on_best
        return self

    def __exit__(self, *exc):
        self._mod.score_candidates, self._mod.find_best_candidate = self._orig


def _host(a):
    return a.detach().cpu().numpy().copy() if isinstance(a, torch.Tensor) else np.array(a)


def planes(te) -> dict:
    """``compare_observations``' planes after the port's step: the port's
    spec of each map plane, its offset (moved by a recenter or a grown pub
    map) and its footprint (None for the pub map's carve; a scan-match
    map's blur half-width, 0 without blur)."""
    fs, cfg, st = te.fspec, te.config, te.state
    half = lambda spec, blur: spec.kernel_half if blur else 0
    off = lambda m: _host(m.offset)
    return {"pub_hits": (fs.pub_spec, off(st.pub), None),
            "pub_passes": (fs.pub_spec, off(st.pub), None),
            "coarse_probs": (fs.coarse_spec, off(st.coarse),
                             half(fs.coarse_spec, cfg.coarse_map_use_blur)),
            "fine_probs": (fs.fine_spec, off(st.fine),
                           half(fs.fine_spec, cfg.fine_map_use_blur))}


def classify_by_grids(ref_tiers: list, got_tiers: list) -> dict:
    """A verdict on a step whose pose or covariance missed its bar, from
    the tier grids both engines recorded (``GridTap``) along their own
    chains, by ``parity.classify_chain``: ``pose`` "tie_flip" where the
    first tier whose tie sets differ has them differ only by candidates
    within 1e-5 of the line, scores within 1e-5 (``parity.classify_tier``);
    ``cov`` "top_flip" where the first tier whose covariance windows differ
    has them differ only by candidates within 1e-5 of the 20th score,
    scores within 1e-5 (``parity.classify_top``); each only where every
    tier before it is the same; else "fault"; with the tiers' margins. The
    front-end step's tiers are the first three of each list (unbatched
    grids)."""
    names = ("coarse", "fine", "super_fine")
    pairs = [(n, a, b) for n, a, b in zip(names, ref_tiers, got_tiers)
             if a["grid"].ndim == 3 and a["grid"].shape == b["grid"].shape]
    ties = {n: parity.classify_tier(a["grid"], b["grid"]) for n, a, b in pairs}
    tops = {n: parity.classify_top(a["grid"], b["grid"]) for n, a, b in pairs}
    return {**parity.classify_chain(ties, tops), "tiers": ties, "windows": tops}


def lockstep(ref, feed, ref_tap=None, classify=None, device="cpu", name: str = "",
             on_step=None, first=None, report=None, **engine_kwargs) -> parity.LockstepReport:
    """Feed ``feed`` to the reference engine ``ref`` one scan at a time; a
    fresh port engine on ``device`` (``engine_kwargs`` to its constructor:
    ``ref``'s mode, in its blocking form) is carried into ``ref``'s state
    before each and takes the same scan. ``feed``: (method, args) per scan,
    ``method`` "process" (ranges, odometry, stamp), "process_points"
    (points, mask, n_valid, odometry, stamp), or another method both
    engines have (``finish``, ``force_graph_optimize``: no step; the
    decisions and poses compared). Each step is held at
    ``parity.compare_observations``' bars.

    ``ref_tap``: records ``ref``'s step — a context manager for each step
    with ``summary`` and ``seen`` (the scan) after it; None: ``ref`` is a
    port engine (``PortTap``, and ``GridTap`` on both for the classifier).
    ``classify(z, te, seen, ref_tiers, got_tiers)`` gives the verdict on a
    step off its pose or covariance bar (None: ``classify_by_grids``, for a
    port reference; False: none). ``first``: the port engine for the first
    step (one loaded from a checkpoint of ``ref``). ``on_step(k, row, ref,
    te)`` is called after each step. Returns the ``parity.LockstepReport``
    (``report``, when given, goes on: its steps are numbered on)."""
    import contextlib

    rep = report if report is not None else parity.LockstepReport(name)
    if classify is None:
        classify = lambda z, te, seen, a, b: classify_by_grids(a, b)
    grids = ref_tap is None and classify is not False
    for i, (method, args) in enumerate(feed):
        k = len(rep.rows)
        z = engine_arrays(ref)
        te = first if i == 0 and first is not None else carry(z, device, **engine_kwargs)
        before = parity.counts(ref), parity.counts(te)
        with (ref_tap() if ref_tap is not None else PortTap()) as rt, \
                (GridTap() if grids else contextlib.nullcontext()) as rg:
            kr = getattr(ref, method)(*args)
        with PortTap() as pt, (GridTap() if grids else contextlib.nullcontext()) as tg:
            kt = getattr(te, method)(*args)
        seen = rt.seen
        row = parity.compare_observations(
            parity.observe(ref, kr, rt.summary), parity.observe(te, kt, pt.summary),
            *before, scan=None if seen is None else (seen["points"], seen["mask"]),
            planes=planes(te))
        tie = None
        if (row["pose_bar"] or row["cov_bar"]) and classify is not False and seen is not None:
            tie = classify(z, te, seen, rg.tiers if grids else None,
                           tg.tiers if grids else None)
        row = rep.add(k, row, tie)
        if on_step is not None:
            on_step(k, row, ref, te)
    return rep
