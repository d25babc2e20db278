"""A run of the harness at a small size on the CPU, the look for a card
skipped, with the program's timed path left sound or broken underneath:

    python slambench/tests/_tiny_run.py <sound|frozen|moved|half_batch> <seed>

``frozen``: the front-end step returns its state unchanged (no map update,
no pose); ``moved``: the step's pose altered by 1 mm where it is produced;
``half_batch``: the chain batch's second half left out (its responses
zero; a batch of one is the second half). Prints the harness's lines; the last is its result."""

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

SMALL = {"device": "cpu",
         "config": {"fine_map_resolution": 0.05, "match_map_window": 8.0, "max_points": 256,
                    "coarse_search_angle_offset": 0.349},
         "mix": {"laps": 1.15, "laser": {"angle_min": -2.356194490192345,
                                         "angle_max": 2.356194490192345, "range_min": 0.05,
                                         "range_max": 10.0, "num_beams": 181,
                                         "range_threshold_scale": 0.95, "scan_time": 0.025}},
         "workload": {"warm_scans": 5, "solver_buckets": [64], "closure_gap_s": 30.0,
                      "samples": {"start_steps": 2, "steps": 40, "chain_steps": 1,
                                  "closures": 1}}}


def break_program(fault: str):
    import torch

    from roborts_slam_tpu_torch import engine
    from roborts_slam_tpu_torch.backend import processor

    step = processor.frontend_step

    def planes(st):
        return [st.pub.hits, st.pub.passes, st.coarse.probs, st.fine.probs, st.pose,
                st.last_map_update_pose]

    def frozen(fspec, state, *a, **k):
        keep = [t.clone() for t in planes(state)]
        out = step(fspec, state, *a, **k)
        for t, c in zip(planes(state), keep):
            t.copy_(c)
        return out

    def moved(fspec, state, *a, **k):
        st, info = step(fspec, state, *a, **k)
        info.packed[0] += 1e-3
        return st, info

    if fault in ("frozen", "moved"):
        fn = frozen if fault == "frozen" else moved
        engine.frontend_step = processor.frontend_step = fn
    elif fault == "half_batch":
        def halved(match):
            def half(*a, **k):
                pose, score, cov = match(*a, **k)
                B = score.shape[0]
                return pose, torch.where(torch.arange(B) < B // 2, score, 0.0), cov
            return half

        processor.chain_match = halved(processor.chain_match)
        processor.chain_match_batch_gather = halved(processor.chain_match_batch_gather)


if __name__ == "__main__":
    from lib.harness import forbidden_modules, run

    fault, seed = sys.argv[1], sys.argv[2]
    if fault != "sound":
        break_program(fault)
    rc = run(["--workload", "real_robot.corridor_lap", "--seed", seed, "--seconds", "50",
              "--trace", "0"], time.perf_counter(), SMALL)
    assert not forbidden_modules(), forbidden_modules()
    sys.exit(rc)
