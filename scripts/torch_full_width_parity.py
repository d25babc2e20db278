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

``--lockstep LEG:N``: the first N fed scans in lockstep: before each, the JAX
engine's whole state is carried into a fresh port engine, both take the
scan, and the port's step is held at the per-step bars (pose 1e-5 m / 1e-5
rad, score 1e-5, positional covariance 1e-3 relative, the same decisions,
map cells equal but those a pose's last bits decide; ``bench/parity.py``).
One line per scan (pose gap, the cells of the pub, coarse and fine maps that
differ, the bars missed; a step whose pose misses its bar is diagnosed from
JAX's state as above: a tie flip or not), then the run's summary. The
shared helper is ``tests/_torch_lockstep.py``.

``--write``: the JAX package alone over the three legs; writes
``tests/data/jax_full_width.npz`` (per leg the log's SHA-256, kept fed ids,
poses, link / closure / solve counts, ATE against the simulated truth for
legs 3 and 4, the published map as int8). Rewrite it only after a deliberate
change of the JAX package's semantics, and say so in the commit.
"""

from __future__ import annotations

import argparse
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
from tests import _torch_lockstep as L  # noqa: E402

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
        tap = L.StepTap(je)
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
        own = dict(tap.seen, state=L.state_arrays(te.state))
        gap = parity.pose_gap(own["state"]["pose"][None], tap.seen["state"]["pose"][None])[0]
        results = {}
        for name, seen in (("jax_state", tap.seen), ("port_state", own)):
            t0 = time.perf_counter()
            results[name] = res = L.compare_step(je, te, seen)
            emit({"leg": leg, "scan": k, "from": name, "jax_kept": kept,
                  **({"state_pose_gap": gap} if name == "port_state" else {}),
                  **{q: v for q, v in res.items() if not q.startswith("_")},
                  "seconds": time.perf_counter() - t0})
        emit({"leg": leg, "scan": k, "state_pose_gap": gap,
              "jax_from_its_state_vs_from_the_port_state": L.state_sensitivity(
                  results["jax_state"], results["port_state"])})


def lockstep_row(k: int, row: dict) -> dict:
    """``--lockstep``'s line for one step (``parity.compare_observations``'
    row as ``parity.LockstepReport`` keeps it)."""
    return {"scan": k, "kept": row["kept"],
            "pose_gap": [row.get("pose_gap_m"), row.get("pose_gap_rad")],
            **{m: (v["differing"] if isinstance(v, dict) else v) for m, v in row["maps"].items()},
            "score_diff": row.get("score_diff"), "cov_xy_rel_diff": row.get("cov_xy_rel_diff"),
            "links": row["links"], "closures": row["closures"], "failed": row["failed"],
            **{q: row[q] for q in ("tie_flip", "not_a_tie_flip") if q in row}}


def lockstep(arg):
    """The first N fed scans of a leg in lockstep (``tests/_torch_lockstep.py``):
    before each, JAX's whole engine state is carried into a fresh port
    engine, both take the scan, and the port's step is held at the per-step
    bars (``parity.compare_observations``). One line per scan (its pose gap,
    the map cells that differ, the bars missed; a step that misses its pose
    bar is diagnosed from JAX's state, tie flip or not), then the run's
    summary."""
    leg, (n,) = _parse(arg)
    inputs = _all_inputs([leg])[leg]
    scans = [("process", (inputs["ranges"][k], inputs["odom"][k], float(inputs["times"][k])))
             for k in range(n)]
    rep = L.lockstep(jax_engine(leg, inputs), scans, name=leg,
                     on_step=lambda k, row, je, te: emit(lockstep_row(k, row)))
    emit({"leg": leg, "lockstep": rep.summary()})


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
