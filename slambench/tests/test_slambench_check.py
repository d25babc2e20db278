"""The check's own rules on the CPU: the verdict asks for what the cell
samples, the samples are drawn over the whole window, and a tier's flips are
told apart from its sound decisions (equal scores at the covariance's cut
that are summed alike, a centre shifted by a few float32 spacings)."""

import math

import numpy as np
import torch

from lib import check, harness


def numbers(**over):
    n = {"steps_checked": 12, "chain_steps_checked": 2, "closures_checked": 1,
         "step_decisions": 0, "step_pose_gap_m": 1e-6}
    n.update(over)
    return n


WL = {"limits": {"step_decisions": 0, "step_pose_gap_m": 1e-4},
      "samples": {"start_steps": 3, "steps": 9, "chain_steps": 1, "closures": 1}}


def test_verdict_holds_every_number_and_the_coverage():
    ok, judged = check.verdict(numbers(), 0, WL)
    assert ok and judged["closures_checked"] == {"value": 1, "at_least": 1}
    assert not check.verdict(numbers(step_pose_gap_m=2e-4), 0, WL)[0]
    assert not check.verdict(numbers(closures_checked=0), 0, WL)[0]
    assert not check.verdict(numbers(chain_steps_checked=0), 0, WL)[0]
    assert not check.verdict(numbers(), 1, WL)[0]
    no_closures = {**WL, "samples": {**WL["samples"], "closures": 0, "chain_steps": 0}}
    assert check.verdict(numbers(closures_checked=0, chain_steps_checked=0), 0, no_closures)[0]


def test_samples_are_drawn_over_the_whole_window():
    seconds = 50.0
    wl = {"closure_gap_s": 10.0, "samples": WL["samples"]}
    late = []
    for seed in range(40):
        rec = harness.Recorder(wl, seconds, np.random.default_rng([seed, 15]))
        assert len(rec.step_at) == 9 and len(rec.chain_at) == 1 and len(rec.closure_at) == 1
        assert all(0 <= t < seconds for t in rec.step_at)
        assert rec.closure_at[0] <= seconds - 10.0 and rec.chain_at[0] <= 0.8 * seconds
        late.append(max(rec.step_at))
    assert max(late) > 0.9 * seconds          # the end of the window is sampled too
    rec = harness.Recorder(wl, seconds, np.random.default_rng([1, 15]))
    kinds = [rec.kind(i, t) for i, t in enumerate([0.0, 0.0, 0.0, 0.0, seconds])]
    assert kinds[:4] == ["start", "start", "start", None]
    assert kinds[4] == "step"


def flat_tier(**over):
    t = {"scores": torch.tensor([[[0.2, 0.9], [0.5, 0.3]]]), "response": torch.tensor(0.9),
         "threshold": 0.5, "cut_margin": math.inf, "shift_pose_cells": 1e-4,
         "shift_pose_rad": 1e-6, "shift_cov_rel": 1e-6}
    t.update(over)
    return t


def test_margins_name_the_flips():
    m = check.decision_margins([flat_tier()])
    assert m["pose"] > check.TIE_EPS and m["cov"] == math.inf
    # the first tier's shift is left out: its centre is the odometry prediction
    m = check.decision_margins([flat_tier(shift_pose_cells=0.5)])
    assert m["shift_cells"] == 0.0
    m = check.decision_margins([flat_tier(), flat_tier(shift_pose_cells=0.5, cut_margin=0.0)])
    assert m["shift_cells"] == 0.5 and m["cov"] == 0.0


def test_equal_scores_at_the_cut_summed_alike_are_no_flip():
    from slamref.models.grid_map import ProbMapSpec
    from slamref.ops import correlative as C

    spec = ProbMapSpec(resolution=0.05, height=32, width=32, deviation=0.05,
                       blur_offset=0.0, default_prob=0.5)
    params = C.CorrelativeParams(0.5, 0.05, 0.02, 0.01, 0.1, 8, False, C.FINE)
    pts = torch.tensor([[0.3, 0.0], [0.0, 0.3], [-0.3, 0.0], [0.0, -0.3]] * 2)
    pose = torch.tensor([0.8, 0.8, 0.0])
    off = torch.zeros(2)
    center = C.world_to_map_pose(off, spec.inv_res, pose)
    flat_map = torch.full((32, 32), 0.7)         # every candidate reads the same cells' values
    scores, *_ = C.score_candidates(spec, params, flat_map, off, pts, None, 8, center,
                                    pose_world=pose)
    best = scores.max()
    alike = C._positional_cut(spec, params, flat_map, off, pts, 8, pose, center, scores, best)
    assert alike == math.inf or alike > 0      # structural ties: no flip
    rough = torch.rand((32, 32), generator=torch.Generator().manual_seed(3))
    tied = torch.zeros_like(scores).reshape(-1)
    tied[:] = torch.linspace(0.95, 0.5, tied.numel())
    tied[20] = tied[21] = tied[19]                # equal scores at the 20th of different cells
    m = C._positional_cut(spec, params, rough, off, pts, 8, pose, center,
                          tied.reshape(scores.shape), tied.max())
    assert m == 0.0
