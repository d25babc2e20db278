#!/usr/bin/env python3
"""The port against the JAX package at full width, on the CPU.

    python scripts/torch_full_width_parity.py [--legs leg1,leg3,leg4]
    python scripts/torch_full_width_parity.py --diagnose leg4:29,100
    python scripts/torch_full_width_parity.py --lockstep leg4:30
    python scripts/torch_full_width_parity.py --write

The legs are the three configurations ``chip_smoke.py`` drives at full
width, on the same inputs (``roborts_slam_tpu_torch/bench/parity.py``):
leg 1 ``configs/simulation.yaml`` with 1152 points and a 30 m world (3072²
fine map) on the willow scans out and back, leg 3 ``configs/real_robot.yaml``
on the 762-scan corridor loop simulated from seed 20, leg 4 the default
``SlamConfig()`` with 1152 points and a 40 m world (4096² fine map) on that
log's first 200 scans. Both packages run the blocking engine in its default
(fused) mode, the port with its plain versions on the CPU, one torch thread.

Default: each leg through both engines, scan by scan. Prints, per leg, the
first fed scan whose pose parts beyond 2e-3 m / 2e-3 rad and the first whose
kept decision differs, then the end of the run held against JAX's as
``chip_smoke.py``'s ``jax_full_width`` phase holds the card's (one JSON line
per leg). About 5 minutes; leg 3's log takes 20 s to simulate.

``--diagnose LEG:K[,K]``: JAX's engine runs to just before fed scan K; its
front-end state and scan K's points are carried into the port, and each
stage of the step is compared on the same inputs (every stage is fed JAX's
output of the stage before): the prediction, the optimizer (pose, cost,
iterations, fallback), each correlative tier (raw and penalized score grids,
the tie sets against the line ``best - 0.01``, pose, covariance), the map
check's penalty, the gates, and the cells the map update changes. Then the
whole step of each package from that state. One JSON line per scan, with a
``kind``: "agrees" (every stage within its bar, the same gates and map
cells), "tie_flip" (the tier scores within 1e-5 and the tie sets differing
only by candidates within 1e-5 of the line) or "fault".

``--lockstep LEG:N``: both engines run free over the first N fed scans; after
each scan their states are compared (pose gap, cells of the pub, coarse and
fine maps that differ). Each scan after which the pose gap first passes
1e-5, 1e-4 or 1e-3 m, or more map cells differ, is diagnosed as above, from
JAX's state and from the port's.

``--write``: the JAX package alone over the three legs; writes
``tests/data/jax_full_width.npz`` (per leg the log's SHA-256, kept fed ids,
poses, link / closure / solve counts, ATE against the simulated truth for
legs 3 and 4, the published map as int8). Rewrite it only after a deliberate
change of the JAX package's semantics, and say so in the commit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np      # noqa: E402
import torch            # noqa: E402

from roborts_slam_tpu_torch.bench import parity  # noqa: E402

torch.set_num_threads(1)   # one fixed order of every float sum


def _plain(o):
    return o.tolist() if isinstance(o, np.ndarray) else float(o)


def emit(obj):
    print(json.dumps(obj, default=_plain), flush=True)


# ---- the two engines ----

def _config(pkg, leg):
    spec = parity.LEGS[leg]
    if spec["config"] is None:
        return pkg.SlamConfig().replace(**spec["over"])
    return pkg.load_config(str(ROOT / spec["config"]), **spec["over"])


def jax_engine(leg, inputs):
    import roborts_slam_tpu as J
    from roborts_slam_tpu.models.scan import LaserModel

    return J.SlamEngine(_config(J, leg), LaserModel.from_array(inputs["laser"].to_array()),
                        world_size=parity.LEGS[leg]["world_size"])


def port_engine(leg, inputs):
    import roborts_slam_tpu_torch as T

    return T.SlamEngine(_config(T, leg), inputs["laser"],
                        world_size=parity.LEGS[leg]["world_size"], device="cpu")


def jax_ate(traj, gt, times):
    from roborts_slam_tpu.utils.evaluation import ate_rmse, match_by_time

    est, g = match_by_time(traj, gt, times)
    return ate_rmse(est, g)


def feed(eng, inputs, k):
    return bool(eng.process(inputs["ranges"][k], inputs["odom"][k],
                            float(inputs["times"][k])))


def finish(eng, leg):
    """What ``chip_smoke.py`` does after the feed: leg 1 forces one graph
    optimisation; ``run`` (legs 3 and 4) ends with ``finish()``."""
    eng.finish()
    if parity.LEGS[leg]["force_optimize"]:
        eng.force_graph_optimize()


def _all_inputs(legs):
    loop = None
    if any(parity.LEGS[leg]["log"] == "corridor_loop" for leg in legs):
        t0 = time.perf_counter()
        loop = parity.corridor_loop_log()
        print(f"corridor log simulated in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    return {leg: parity.leg_inputs(leg, loop) for leg in legs}


# ---- free runs ----

def free_runs(legs):
    all_inputs = _all_inputs(legs)
    for leg in legs:
        inputs = all_inputs[leg]
        je, te = jax_engine(leg, inputs), port_engine(leg, inputs)
        n = len(inputs["times"])
        first_pose = first_kept = None
        t0 = time.perf_counter()
        for k in range(n):
            kj, kt = feed(je, inputs, k), feed(te, inputs, k)
            if kj != kt and first_kept is None:
                first_kept = k
            if kj and kt and first_pose is None:
                gap = parity.pose_gap(te.trajectory[-1][1][None], je.trajectory[-1][1][None])[0]
                if gap[0] > parity.POS_TOL or gap[1] > parity.ANG_TOL:
                    first_pose = {"scan": k, "gap_m": gap[0], "gap_rad": gap[1]}
        finish(je, leg)
        finish(te, leg)
        ref = parity.leg_record(je, inputs, jax_ate)
        got = parity.leg_record(te, inputs, parity.port_ate)
        sha = parity.inputs_sha256(inputs)
        ref["sha256"] = sha
        report, failed = parity.compare_leg(got, ref, sha)
        emit({"leg": leg, "scans_fed": n, "first_pose_parting_while_fed": first_pose,
              "first_kept_decision_differing": first_kept, **report, "failed": failed,
              "seconds": time.perf_counter() - t0})


def write_fixture(legs):
    all_inputs = _all_inputs(legs)
    records, hashes = {}, {}
    for leg in legs:
        inputs = all_inputs[leg]
        je = jax_engine(leg, inputs)
        for k in range(len(inputs["times"])):
            feed(je, inputs, k)
        finish(je, leg)
        records[leg] = parity.leg_record(je, inputs, jax_ate)
        hashes[leg] = parity.inputs_sha256(inputs)
        emit({"leg": leg, "sha256": hashes[leg], "kept": int(records[leg]["kept_ids"].size),
              **{k: records[leg][k] for k in ("links", "closures", "solves", "ate_m")}})
    import jax

    parity.save_fixture(parity.FIXTURE, records, hashes,
                        f"written by scripts/torch_full_width_parity.py --write "
                        f"with the JAX package on the CPU (jax {jax.__version__})")
    emit({"wrote": str(parity.FIXTURE.relative_to(ROOT)),
          "bytes": parity.FIXTURE.stat().st_size})


# ---- one step from JAX's state ----

def _state_arrays(state) -> dict:
    """A front-end state (either package's) as NumPy arrays by
    ``convert.STATE_KEYS`` name."""
    to = lambda a: (a.detach().cpu().numpy().copy() if isinstance(a, torch.Tensor)
                    else np.array(a))       # a copy: the port's step writes in place
    return {"pub_hits": to(state.pub.hits), "pub_passes": to(state.pub.passes),
            "pub_offset": to(state.pub.offset),
            "coarse_probs": to(state.coarse.probs),
            "coarse_offset": to(state.coarse.offset),
            "fine_probs": to(state.fine.probs), "fine_offset": to(state.fine.offset),
            "pose": to(state.pose), "last_map_update_pose": to(state.last_map_update_pose),
            "map_penalize_times": to(state.map_penalize_times),
            "scan_index": to(state.scan_index), "last_kept_odom": to(state.last_kept_odom)}


class StepTap:
    """Records the front-end state and the scan that the JAX engine hands
    its step (blocking or fused) while ``armed``, before the step runs (the
    step donates the state's buffers)."""

    def __init__(self, je):
        import roborts_slam_tpu.backend.processor as jbp

        self.armed, self.seen = False, None
        self._jbp, self._fused = jbp, jbp.fused_frontend_chain_step
        step = je._step

        def on_step(spec, state, points, mask, n_valid, odom):
            self._grab(state, points, mask, n_valid, odom)
            return step(spec, state, points, mask, n_valid, odom)

        def on_fused(fspec, bspec, state, points, mask, n_valid, odom, *rest):
            self._grab(state, points, mask, n_valid, odom)
            return self._fused(fspec, bspec, state, points, mask, n_valid, odom, *rest)

        je._step = on_step
        jbp.fused_frontend_chain_step = on_fused

    def _grab(self, state, points, mask, n_valid, odom):
        if self.armed:
            self.seen = dict(state=_state_arrays(state), points=np.array(points),
                             mask=np.array(mask), n_valid=int(n_valid),
                             odom=np.array(odom))
            self.armed = False

    def close(self):
        self._jbp.fused_frontend_chain_step = self._fused


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
    from roborts_slam_tpu_torch.convert import state_from_jax
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
    jax_grids = {}       # JAX's penalized grids along its own chain
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
                spec_t, pt_, *fine_t, tp, tm, nv, c), c)
            return grid, tc.correlative_scan_match(spec_t, pt_, *fine_t, tp, tm, nv, pose, cov)

        gj, rj = jtier(*fine_j, jnp.asarray(pose_j), jnp.asarray(cov_j), jnv)
        gt, rt = ttier(pose_t, cov_t)
        gx, rx = jtier(*fine_j, jnp.asarray(pose_t), jnp.asarray(cov_t), jnv)
        gap = parity.pose_gap(np.asarray(pose_t)[None], np.asarray(pose_j)[None])[0]
        same = parity.classify_tier(_np(gx), _np(gt))
        if same["kind"] == "fault":
            same.update(edge_flips(tc, tgm, spec_t, pt_, fine_t[1], pts, nv, pose_t,
                                   _np(gx), _np(gt)))
        own = parity.classify_tier(_np(gj), _np(gt))
        out["tiers"][name] = {
            "input_gap_m": gap[0], "input_gap_rad": gap[1],
            "same_input": {**same, "pose_max_abs_diff": _maxdiff(rx.pose, rt.pose),
                           "cov_max_abs_diff": _maxdiff(rx.cov, rt.cov),
                           "response": [float(rx.response), float(rt.response)]},
            "own_inputs": {**own, "pose_max_abs_diff": _maxdiff(rj.pose, rt.pose)},
            "jax_own_vs_at_port_input_pose_diff": _maxdiff(rj.pose, rx.pose),
            "pose": np.array(rj.pose)}
        jax_grids[name] = _np(gj)
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
    out["_jax_grids"] = jax_grids
    out["differ_on_same_input"] = differ
    out["tie_sets_differ_along_the_chains"] = flipped_at
    if differ:
        out["kind"] = "fault"
    elif parted:
        out["kind"] = "tie_flip"
    else:
        out["kind"] = "agrees"
    return out


def edge_flips(tc, tgm, spec_t, pt_, off_t, pts, nv, pose, grid_j, grid_t) -> dict:
    """Where a tier's two score grids differ on the same input: for each
    candidate whose scores differ beyond 1e-5, the nearest approach of one
    of its samples' cell coordinates ``r + x + 0.5`` (the port's) to a cell
    edge, where ``floor`` switches cells. A sample that close to an edge
    lands in either cell by the last bits of its rotation (the packages'
    cos, sin and multiply-adds round differently). If every differing
    candidate has a sample within 1e-3 cells of an edge, the grids differ
    by rounding at cell edges: ``kind`` "cell_edge_flip"."""
    c = tgm.world_to_map_pose(off_t, spec_t.inv_res, torch.as_tensor(pose))
    g = tc.candidate_grid(spec_t, pt_, torch.as_tensor(pts), nv, c)
    sv = _np(g.svalid)[None, :, None]
    dist = []
    for r, v in ((g.rx, g.xs), (g.ry, g.ys)):
        u = _np(r[:, :, None] + v[None, None, :] + 0.5).astype(np.float64)   # (A, S, N)
        d = np.abs(u - np.round(u))
        dist.append(np.where(sv, d, np.inf).min(1))                          # (A, N)
    near = np.minimum(dist[0][:, :, None], dist[1][:, None, :])              # (A, Nx, Ny)
    differ = np.abs(grid_j.astype(np.float64) - grid_t) > 1e-5
    need = float(near[differ].max()) if differ.any() else 0.0
    return {"candidates_differing": int(differ.sum()),
            "edge_dist_of_their_closest_sample_max_cells": need,
            **({"kind": "cell_edge_flip"} if need <= 1e-3 else {})}


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


def _parse(arg):
    leg, ks = arg.split(":")
    return leg, [int(k) for k in ks.split(",")]


def diagnose(arg):
    """``compare_step`` before each scan K of a leg: from JAX's state, and
    from the port's own state of its free run (JAX's stages then run on the
    port's state too)."""
    leg, scans = _parse(arg)
    inputs = _all_inputs([leg])[leg]
    for k in scans:
        je, te = jax_engine(leg, inputs), port_engine(leg, inputs)
        tap = StepTap(je)
        try:
            for i in range(k):
                feed(je, inputs, i)
                feed(te, inputs, i)
            tap.armed = True
            kept = feed(je, inputs, k)
        finally:
            tap.close()
        if tap.seen is None:
            emit({"leg": leg, "scan": k, "kind": "dropped by the move gate before the step"})
            continue
        own = dict(tap.seen, state=_state_arrays(te.state))
        gap = parity.pose_gap(own["state"]["pose"][None], tap.seen["state"]["pose"][None])[0]
        results = {}
        for name, seen in (("jax_state", tap.seen), ("port_state", own)):
            t0 = time.perf_counter()
            results[name] = res = compare_step(je, te, seen)
            emit({"leg": leg, "scan": k, "from": name, "jax_kept": kept,
                  **({"state_pose_gap": gap} if name == "port_state" else {}),
                  **{q: v for q, v in res.items() if not q.startswith("_")},
                  "seconds": time.perf_counter() - t0})
        emit({"leg": leg, "scan": k, "state_pose_gap": gap,
              "jax_from_its_state_vs_from_the_port_state": state_sensitivity(
                  results["jax_state"], results["port_state"])})


def lockstep(arg):
    """Both engines free over the first N fed scans; their states compared
    after every scan. A scan after which the state's pose gap first passes
    1e-5, 1e-4 or 1e-3 m, or after which more map cells differ than before,
    is diagnosed with ``compare_step`` from JAX's state and from the port's
    (summary lines only)."""
    leg, (n,) = _parse(arg)
    inputs = _all_inputs([leg])[leg]
    je, te = jax_engine(leg, inputs), port_engine(leg, inputs)
    tap = StepTap(je)
    maps = ("pub_hits", "pub_passes", "coarse_probs", "fine_probs")
    seen_diff = {m: 0 for m in maps}
    marks = [1e-5, 1e-4, 1e-3]
    try:
        for k in range(n):
            pre_t = _state_arrays(te.state)
            tap.armed = True
            kj, kt = feed(je, inputs, k), feed(te, inputs, k)
            before, tap.seen = tap.seen, None
            sj, st = _state_arrays(je.state), _state_arrays(te.state)
            gap = parity.pose_gap(st["pose"][None], sj["pose"][None])[0]
            row = {"scan": k, "kept": [kj, kt], "pose_gap": gap}
            why = []
            while marks and gap[0] >= marks[0]:
                why.append(f"pose gap past {marks.pop(0)} m")
            for m in maps:
                nd = (int((sj[m] != st[m]).sum()) if sj[m].shape == st[m].shape else -1)
                row[m] = nd
                if nd > seen_diff[m]:
                    why.append(f"{m} cells {seen_diff[m]} -> {nd}")
                seen_diff[m] = max(nd, 0)
            emit(row)
            if why and before is not None:
                results = {}
                for name, state in (("jax_state", before["state"]), ("port_state", pre_t)):
                    results[name] = res = compare_step(je, te, dict(before, state=state),
                                                       iterations=False)
                    emit({"scan": k, "why": why, "from": name, "kind": res["kind"],
                          "differ_on_same_input": res["differ_on_same_input"],
                          "tie_sets_differ_along_the_chains":
                              res["tie_sets_differ_along_the_chains"],
                          "tiers": {t: {"input_gap_m": v["input_gap_m"],
                                        "same_input": {q: v["same_input"].get(q) for q in (
                                            "kind", "scores_max_abs_diff", "flipped",
                                            "edge_dist_of_their_closest_sample_max_cells")},
                                        "own_inputs": {q: v["own_inputs"][q] for q in (
                                            "scores_max_abs_diff", "flipped",
                                            "flipped_max_dist_to_line",
                                            "lowest_inside_above_line",
                                            "closest_outside_below_line",
                                            "pose_max_abs_diff")}}
                                    for t, v in res["tiers"].items()},
                          "optimizer": res.get("optimizer"),
                          "map_feedback_penalty": res.get("map_feedback_penalty"),
                          "step": {q: res["step"][q] for q in (
                              "gap_m", "gap_rad", "map_updated", "pose_accepted",
                              "fine_cells_differing", "coarse_cells_differing",
                              "pub_hits_cells_differing")}})
                emit({"scan": k, "jax_from_its_state_vs_from_the_port_state":
                      state_sensitivity(results["jax_state"], results["port_state"])})
    finally:
        tap.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default="leg1,leg3,leg4")
    ap.add_argument("--diagnose", metavar="LEG:K[,K]", action="append", default=[])
    ap.add_argument("--lockstep", metavar="LEG:N", action="append", default=[])
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    legs = args.legs.split(",")
    if args.write:
        write_fixture(legs)
    for arg in args.diagnose:
        diagnose(arg)
    for arg in args.lockstep:
        lockstep(arg)
    if not (args.write or args.diagnose or args.lockstep):
        free_runs(legs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
