"""The port held against the JAX package one carried step at a time: the
part that reads the JAX engine (the port itself never imports JAX). The
carry, the per-step bars and the report are the port's
(``roborts_slam_tpu_torch/bench/lockstep.py``, ``bench/parity.py``);
``scripts/torch_full_width_parity.py`` and the tests call what is here.

``lockstep(je, feed, ...)`` feeds the JAX engine ``je`` its scans one at a
time; before each, the JAX engine's whole state is carried into a fresh
port engine, both engines take the same scan, and the port's step is held
against JAX's (``parity.compare_observations``). A step whose pose or
covariance alone misses its bar is diagnosed stage by stage from JAX's
state (``compare_step``) and counts as a flip only where a tier of the two
chains says so (``parity.classify_chain``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from roborts_slam_tpu_torch.bench import lockstep as port_lockstep
from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.bench.lockstep import carry, engine_arrays, state_arrays
from roborts_slam_tpu_torch.convert import state_from_jax

__all__ = ["StepTap", "carry", "classify_step", "compare_step", "engine_arrays", "lockstep",
           "scans", "state_arrays", "state_sensitivity", "assert_free", "assert_lockstep"]


class StepTap:
    """Records what the JAX engine hands its step (blocking, windowed or
    fused) while ``armed``: the front-end state and the scan, before the
    step runs (the step donates the state's buffers), as ``seen``; and the
    step's packed summary, as ``summary``. As a context manager it is armed
    on entry and taken off the engine on exit."""

    def __init__(self, je):
        import jax

        import roborts_slam_tpu.backend.processor as jbp

        self.armed, self.seen, self.summary = False, None, None
        self._jbp, self._fused = jbp, jbp.fused_frontend_chain_step
        self._je, self._orig = je, {}

        def tapped(fn, state_at, scan_at):
            def run(*args):
                take = self.armed
                if take:
                    self._grab(args[state_at], *args[scan_at:scan_at + 4])
                out = fn(*args)
                if take:
                    self.summary = np.asarray(jax.device_get(out[1]), np.float64)
                return out
            return run

        for name in ("_step", "_step_windowed"):
            if hasattr(je, name):
                self._orig[name] = getattr(je, name)
                # (spec, state, points, ...) / (spec, state, all_points, all_masks,
                # all_poses, win_ids, points, ...)
                setattr(je, name, tapped(getattr(je, name), 1, 2 if name == "_step" else 6))
        # (fspec, bspec, state, points, ...)
        jbp.fused_frontend_chain_step = tapped(self._fused, 2, 3)

    def _grab(self, state, points, mask, n_valid, odom):
        self.seen = dict(state=state_arrays(state), points=np.array(points),
                         mask=np.array(mask), n_valid=int(n_valid), odom=np.array(odom))
        self.armed = False

    def close(self):
        self._jbp.fused_frontend_chain_step = self._fused
        for name, fn in self._orig.items():
            setattr(self._je, name, fn)

    def __enter__(self):
        self.armed = True
        return self

    def __exit__(self, *exc):
        self.armed = False
        self.close()


def classify_step(je, te, seen: dict) -> dict:
    """The JAX engine's verdict on a step whose pose or covariance missed
    its bar: its stages on JAX's state (``compare_step``), the same input in
    both packages, each package along its own chain of tiers. Where no
    stage differs on the same input, ``parity.classify_chain`` on the
    tiers: ``pose`` "tie_flip" where the first tier whose tie sets differ
    has them differ only by candidates within 1e-5 of the line, scores
    within 1e-5 (``parity.classify_tier``); ``cov`` "top_flip" where the
    first tier whose covariance windows differ has them differ only by
    candidates within 1e-5 of the 20th score, scores within 1e-5
    (``parity.classify_top``); each only where every tier before it is the
    same; else "fault"; with the tiers' margins."""
    res = compare_step(je, te, seen, iterations=False)
    ties = {n: {q: t["own_inputs"][q] for q in (
        "kind", "flipped", "flipped_max_dist_to_line", "scores_max_abs_diff", "ties",
        "lowest_inside_above_line", "closest_outside_below_line")}
        for n, t in res["tiers"].items()}
    tops = {n: parity.classify_top(res["_jax_grids"][n], res["_port_grids"][n])
            for n in res["tiers"]}
    verdict = (parity.classify_chain(ties, tops) if not res["differ_on_same_input"]
               else {"pose": "fault", "cov": "fault"})
    return {**verdict, "tiers": ties, "windows": tops,
            "differ_on_same_input": res["differ_on_same_input"]}


def lockstep(je, feed, name: str = "", classify: bool = True, on_step=None,
             first=None, report=None, **engine_kwargs) -> parity.LockstepReport:
    """``bench/lockstep.py``'s ``lockstep`` with the JAX engine ``je`` as the
    reference: its step recorded by ``StepTap``, a step off its pose or
    covariance bar classified by ``classify_step`` (when ``classify``); the
    port engines on the CPU. The other arguments are that function's."""
    verdict = (lambda z, te, seen, *_: classify_step(je, carry(z, **engine_kwargs), seen))
    return port_lockstep.lockstep(je, feed, ref_tap=lambda: StepTap(je),
                                  classify=verdict if classify else False, name=name,
                                  on_step=on_step, first=first, report=report,
                                  **engine_kwargs)


def _maxdiff(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a.astype(np.float64) - b).max())


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def compare_step(je, te, seen: dict, iterations: bool = True) -> dict:
    """Every stage of one front-end step on JAX's state and scan (``seen``,
    from ``StepTap``), in both packages. Each package runs its own chain of
    stages (each stage fed its own package's output of the stage before),
    and each stage of JAX's package also runs on the port's input: so a
    stage's two outputs on the same input tell the implementations apart,
    and JAX's outputs on its own and on the port's input show what the gap
    between the inputs alone does. JAX's stages run under ``jax.jit``, as in
    its engine. ``iterations``: count the optimizer's iterations (one more
    compile and run per possible count)."""
    import jax
    import jax.numpy as jnp

    from roborts_slam_tpu.frontend import processor as jfp
    from roborts_slam_tpu.models import grid_map as jgm
    from roborts_slam_tpu.ops import correlative as jc
    from roborts_slam_tpu.ops import gauss_newton as jg
    from roborts_slam_tpu.ops import raster as jr
    from roborts_slam_tpu.ops import raycast as jrc
    from roborts_slam_tpu.utils import geometry as jgeo
    from roborts_slam_tpu_torch.frontend import processor as tfp
    from roborts_slam_tpu_torch.models import grid_map as tgm
    from roborts_slam_tpu_torch.ops import correlative as tc
    from roborts_slam_tpu_torch.ops import gauss_newton as tg
    from roborts_slam_tpu_torch.ops import raster as tr
    from roborts_slam_tpu_torch.ops import raycast as trc
    from roborts_slam_tpu_torch.utils import geometry as tgeo

    S = seen["state"]
    fj, ft = je.fspec, te.fspec
    cfg = fj.config
    pts, msk, nv, odom = seen["points"], seen["mask"], seen["n_valid"], seen["odom"]
    jp, jm = jnp.asarray(pts), jnp.asarray(msk)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(msk)
    jnv = jnp.int32(nv)            # traced, as the engine's step takes it
    J = lambda k: jnp.asarray(S[k])
    Tt = lambda k: torch.as_tensor(S[k])
    out: dict = {"n_valid": nv}
    differ = []          # stages whose two outputs differ on the same input

    # prediction
    last = S["last_kept_odom"] if int(S["scan_index"]) != 0 else odom
    pred_j = np.array(jax.jit(jgeo.predict_pose_by_odom)(J("pose"), jnp.asarray(last),
                                                         jnp.asarray(odom)))
    pred_t = _np(tgeo.predict_pose_by_odom(Tt("pose"), torch.as_tensor(last),
                                           torch.as_tensor(odom)))
    out["predict"] = {"pose": pred_j, "max_abs_diff": _maxdiff(pred_j, pred_t)}
    if out["predict"]["max_abs_diff"] > 1e-5:
        differ.append("predict")

    mj, mt = fj.matcher, ft.matcher
    eye = np.eye(3, dtype=np.float32)
    pose_j, cov_j, pose_t, cov_t = pred_j, eye, pred_t, eye
    coarse_tier = True
    if mj.use_optimize_scan_match:
        jopt = jax.jit(lambda pr, off, pose, params: jg.optimize_scan_match(
            fj.coarse_spec, params, pr, off, jp, jm, pose), static_argnums=(3,))
        run_j = lambda it: jopt(J("coarse_probs"), J("coarse_offset"), jnp.asarray(pred_j),
                                dataclasses.replace(mj.optimize, iterate_max_times=it))
        run_t = lambda it: tg.optimize_scan_match(
            ft.coarse_spec, dataclasses.replace(mt.optimize, iterate_max_times=it),
            Tt("coarse_probs"), Tt("coarse_offset"), tp, tm, torch.as_tensor(pred_t))

        def stopped_at(run):
            """The step at which the optimizer stopped: the smallest cap of
            ``iterate_max_times`` that gives the full run's result."""
            full = run(mj.optimize.iterate_max_times)
            for it in range(1, mj.optimize.iterate_max_times + 1):
                r = run(it)
                if np.array_equal(_np(r.pose), _np(full.pose)) and \
                        np.array_equal(_np(r.cost), _np(full.cost)):
                    return it
            return mj.optimize.iterate_max_times

        oj, ot = run_j(mj.optimize.iterate_max_times), run_t(mt.optimize.iterate_max_times)
        fail_j = float(oj.cost) > mj.optimize_failed_cost
        fail_t = float(ot.cost) > mt.optimize_failed_cost
        out["optimizer"] = {
            "pose": np.array(oj.pose), "pose_max_abs_diff": _maxdiff(oj.pose, ot.pose),
            "cost": [float(oj.cost), float(ot.cost)],
            **({"iterations": [stopped_at(run_j), stopped_at(run_t)]} if iterations else {}),
            "fell_back_to_coarse_tier": [fail_j, fail_t]}
        if fail_j != fail_t or out["optimizer"]["pose_max_abs_diff"] > 1e-5:
            differ.append("optimizer")
        coarse_tier = fail_j
        if not fail_j:
            pose_j = np.array(oj.pose)
        if not fail_t:
            pose_t = _np(ot.pose)

    # the correlative tiers
    spec_j, spec_t = fj.fine_spec, ft.fine_spec
    fine_j = (J("fine_probs"), J("fine_offset"))
    fine_t = (Tt("fine_probs"), Tt("fine_offset"))
    names = ["coarse", "fine", "super_fine"] if coarse_tier else ["fine", "super_fine"]
    out["tiers"] = {}
    jax_grids, port_grids = {}, {}    # penalized grids along each package's chain
    flipped_at = []
    for name in names:
        pj_, pt_ = getattr(mj, name), getattr(mt, name)

        @jax.jit
        def jtier(pr, off, pose, cov, n, pj_=pj_):
            c = jgm.world_to_map_pose(off, spec_j.inv_res, pose)
            grid = jc.penalize_scores(pj_, spec_j, *jc.score_candidates(
                spec_j, pj_, pr, off, jp, jm, n, c), c)
            return grid, jc.correlative_scan_match(spec_j, pj_, pr, off, jp, jm, n, pose, cov)

        def ttier(pose, cov, pt_=pt_):
            pose, cov = torch.as_tensor(pose), torch.as_tensor(cov)
            c = tgm.world_to_map_pose(fine_t[1], spec_t.inv_res, pose)
            grid = tc.penalize_scores(pt_, spec_t, *tc.score_candidates(
                spec_t, pt_, *fine_t, tp, tm, nv, c, pose_world=pose), c)
            return grid, tc.correlative_scan_match(spec_t, pt_, *fine_t, tp, tm, nv, pose, cov)

        gj, rj = jtier(*fine_j, jnp.asarray(pose_j), jnp.asarray(cov_j), jnv)
        gt, rt = ttier(pose_t, cov_t)
        gx, rx = jtier(*fine_j, jnp.asarray(pose_t), jnp.asarray(cov_t), jnv)
        gap = parity.pose_gap(np.asarray(pose_t)[None], np.asarray(pose_j)[None])[0]
        same = parity.classify_tier(_np(gx), _np(gt))
        if same["kind"] == "fault":
            same.update(parity.edge_flips(spec_t, pt_, fine_t[1], pts, nv, pose_t,
                                          _np(gx), _np(gt)))
        own = parity.classify_tier(_np(gj), _np(gt))
        out["tiers"][name] = {
            "input_gap_m": gap[0], "input_gap_rad": gap[1],
            "same_input": {**same, "pose_max_abs_diff": _maxdiff(rx.pose, rt.pose),
                           "cov_max_abs_diff": _maxdiff(rx.cov, rt.cov),
                           "response": [float(rx.response), float(rt.response)]},
            "own_inputs": {**own, "pose_max_abs_diff": _maxdiff(rj.pose, rt.pose)},
            "jax_own_vs_at_port_input_pose_diff": _maxdiff(rj.pose, rx.pose),
            "pose": np.array(rj.pose), "port_input_pose": np.array(pose_t, np.float32)}
        jax_grids[name], port_grids[name] = _np(gj), _np(gt)
        if same["kind"] == "fault" or out["tiers"][name]["same_input"]["pose_max_abs_diff"] > 1e-5:
            differ.append(f"{name} tier")
        if own["flipped"]:
            flipped_at.append(name)
        pose_j, cov_j, pose_t, cov_t = np.array(rj.pose), np.array(rj.cov), _np(rt.pose), _np(rt.cov)

    # the map check's penalty at each package's matched pose, and JAX's at the port's
    if cfg.use_map_check_feedback:
        pen_args = (cfg.map_check_point_num, cfg.map_check_bound_tolerance,
                    cfg.map_check_penalty_gain)
        jpen = jax.jit(lambda h, p, off, pose, n: jrc.map_feedback_penalty(
            fj.pub_spec, jgm.CountMap(h, p, off), jp, jm, n, pose, *pen_args,
            min_passthrough=jnp.float32(cfg.map_min_passthrough),
            occu_threshold=jnp.float32(cfg.map_occu_threshold)))
        pen = [float(jpen(J("pub_hits"), J("pub_passes"), J("pub_offset"),
                          jnp.asarray(pose), jnv)) for pose in (pose_j, pose_t)]
        pen.insert(1, float(trc.map_feedback_penalty(
            ft.pub_spec, tgm.CountMap(Tt("pub_hits"), Tt("pub_passes"), Tt("pub_offset")),
            tp, tm, nv, torch.as_tensor(pose_t), *pen_args,
            min_passthrough=cfg.map_min_passthrough,
            occu_threshold=cfg.map_occu_threshold)))
        # in f32 steps: XLA contracts 1 + 2 gain - gain * bad into one
        # multiply-add (one rounding), torch rounds the product first; a
        # different bad-ray count moves it by gain / 2**-24 steps
        ulps = abs(pen[1] - pen[2]) / float(np.spacing(np.float32(max(pen[1], pen[2]))))
        out["map_feedback_penalty"] = {"jax": pen[0], "port": pen[1],
                                       "jax_at_port_pose": pen[2], "f32_steps_apart": ulps}
        if ulps > 1:
            differ.append("map_feedback_penalty")

    # the map update at the port's matched pose, in both packages
    def changed(a, b):
        return set(map(tuple, np.argwhere(np.asarray(a) != np.asarray(b))))

    at = jnp.asarray(pose_t)
    new_pub_j = jax.jit(lambda h, p, off: jr.update_count_map(
        fj.pub_spec, jgm.CountMap(h, p, off), jp, jm, at,
        jnp.float32(cfg.map_update_free_factor), jnp.float32(cfg.map_update_occu_factor)))(
        J("pub_hits"), J("pub_passes"), J("pub_offset"))
    pub_t = tgm.CountMap(Tt("pub_hits").clone(), Tt("pub_passes").clone(), Tt("pub_offset"))
    tr.update_count_map(ft.pub_spec, pub_t, tp, tm, torch.as_tensor(pose_t),
                        float(cfg.map_update_free_factor), float(cfg.map_update_occu_factor))
    pairs = [("pub_hits", new_pub_j.hits, pub_t.hits),
             ("pub_passes", new_pub_j.passes, pub_t.passes)]
    for name, spec_jm, spec_tm, blur in (
            ("coarse", fj.coarse_spec, ft.coarse_spec, cfg.coarse_map_use_blur),
            ("fine", fj.fine_spec, ft.fine_spec, cfg.fine_map_use_blur)):
        nj = jax.jit(lambda pr, off: jr.stamp_scan(spec_jm, jgm.ProbMap(pr, off), jp, jm,
                                                   at, use_blur=blur))(
            J(f"{name}_probs"), J(f"{name}_offset"))
        mt_ = tgm.ProbMap(Tt(f"{name}_probs").clone(), Tt(f"{name}_offset"))
        tr.stamp_scan(spec_tm, mt_, tp, tm, torch.as_tensor(pose_t), use_blur=blur)
        pairs.append((f"{name}_probs", nj.probs, mt_.probs))
    upd = {}
    for name, a, b in pairs:
        cj_, ct_ = changed(a, S[name]), changed(b, S[name])
        upd[name] = {"cells_changed": [len(cj_), len(ct_)],
                     "cells_changed_by_one_only": len(cj_ ^ ct_),
                     "values_max_abs_diff": _maxdiff(a, b)}
    out["map_update_at_port_pose"] = upd
    if any(u["values_max_abs_diff"] > 1e-6 or u["cells_changed_by_one_only"]
           for u in upd.values()):
        differ.append("map_update")

    # the whole step of each package from the same state
    st0 = jfp.init_frontend_state(fj)._replace(
        pub=jgm.CountMap(J("pub_hits"), J("pub_passes"), J("pub_offset")),
        coarse=jgm.ProbMap(J("coarse_probs"), J("coarse_offset")),
        fine=jgm.ProbMap(J("fine_probs"), J("fine_offset")),
        pose=J("pose"), last_map_update_pose=J("last_map_update_pose"),
        map_penalize_times=jnp.int32(S["map_penalize_times"]),
        scan_index=jnp.int32(S["scan_index"]), last_kept_odom=J("last_kept_odom"))
    sj, ij = jax.jit(jfp.frontend_step, static_argnames=("spec",))(
        fj, st0, jp, jm, jnv, jnp.asarray(odom, jnp.float32))
    st_, it_ = tfp.frontend_step(ft, state_from_jax(S, "cpu"), tp, tm, nv,
                                 torch.as_tensor(odom, dtype=torch.float32))
    gates = {"pose_accepted": [bool(ij.pose_accepted), bool(it_.pose_accepted)],
             "map_updated": [bool(ij.map_updated), bool(it_.map_updated)]}
    gap = parity.pose_gap(_np(it_.pose)[None], np.array(ij.pose)[None])[0]
    step = {"pose": np.array(ij.pose), "gap_m": gap[0], "gap_rad": gap[1],
            "score": [float(ij.score), float(it_.score)], **gates,
            "cov_max_abs_diff": _maxdiff(ij.cov, it_.cov),
            # the chains above against the packages' own whole steps
            "jax_step_vs_jax_chain": _maxdiff(ij.pose, pose_j),
            "port_step_vs_port_chain": _maxdiff(it_.pose, pose_t)}
    for name, a, b in (("pub_hits", sj.pub.hits, st_.pub.hits),
                       ("pub_passes", sj.pub.passes, st_.pub.passes),
                       ("coarse", sj.coarse.probs, st_.coarse.probs),
                       ("fine", sj.fine.probs, st_.fine.probs)):
        step[f"{name}_cells_differing"] = int((_np(a) != _np(b)).sum())
    out["step"] = step
    parted = (gap[0] > parity.POS_TOL or gap[1] > parity.ANG_TOL
              or any(g[0] != g[1] for g in gates.values()))
    out["_jax_grids"], out["_port_grids"] = jax_grids, port_grids
    out["differ_on_same_input"] = differ
    out["tie_sets_differ_along_the_chains"] = flipped_at
    if differ:
        out["kind"] = "fault"
    elif parted:
        out["kind"] = "tie_flip"
    else:
        out["kind"] = "agrees"
    return out


def state_sensitivity(from_jax: dict, from_port: dict) -> dict:
    """JAX's own step from its state against JAX's own step from the port's
    state (two ``compare_step`` results): per tier the classification of
    the two penalized grids (a candidate that crosses the tie line between
    them, and how far from it) and how far apart the two tier poses are,
    then the step poses. Where the port reproduces JAX on the same state,
    this is what the gap between the states alone does."""
    out = {}
    for name, g in from_jax["_jax_grids"].items():
        h = from_port["_jax_grids"].get(name)
        if h is None or h.shape != g.shape:
            out[name] = "tier not run from both states"
            continue
        cls = parity.classify_tier(g, h)
        gap = parity.pose_gap(np.asarray(from_port["tiers"][name]["pose"])[None],
                               np.asarray(from_jax["tiers"][name]["pose"])[None])[0]
        out[name] = {q: cls[q] for q in ("scores_max_abs_diff", "flipped",
                                         "flipped_max_dist_to_line", "ties",
                                         "lowest_inside_above_line",
                                         "closest_outside_below_line")}
        out[name].update(pose_gap_m=gap[0], pose_gap_rad=gap[1])
    gap = parity.pose_gap(np.asarray(from_port["step"]["pose"])[None],
                           np.asarray(from_jax["step"]["pose"])[None])[0]
    out["step_gap_m"], out["step_gap_rad"] = gap[0], gap[1]
    return out




# ---- what the tests assert ----

def scans(ranges, odom, times) -> list:
    """``lockstep``'s feed of raw scans."""
    return [("process", (ranges[i], odom[i], float(times[i]))) for i in range(len(times))]


def assert_lockstep(rep: parity.LockstepReport) -> dict:
    """Every step of a lockstep run within its bars, at most
    ``parity.TIE_FLIP_CAP`` tie flips; the summary (largest gaps, tie flips
    with their margins) printed."""
    summary = rep.summary()
    print(json.dumps(summary, default=float))
    assert rep.rows and not summary["failed"], summary["failed"]
    return summary


def assert_free(jrec: dict, trec: dict, name: str = "") -> dict:
    """A free run held at ``parity.compare_free``'s bars; the count of
    poses beyond 2e-3 m / 2e-3 rad, the median and largest gap and the
    kept ids that differ printed, not held."""
    report, failed = parity.compare_free(trec, jrec)
    print(json.dumps({"free": name, **report, "failed": failed},
                     default=lambda o: o.tolist() if hasattr(o, "tolist") else float(o)))
    assert not failed, (failed, report)
    return report
