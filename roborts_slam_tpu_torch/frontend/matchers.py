"""Tiered scan-match facade.

Counterpart of the JAX package's ``frontend/matchers.py`` (``ScanMatchers``,
src/scan_match/scan_matchers.h:160-416): coarse→fine→super-fine correlative
passes, all on the fine map (scan_matchers.h:238-260), stage-score averaging
(:281) and the per-tier parameter derivation (ScanMatchParamInit :307-355).

This slice carries the correlative branch only: the Gauss-Newton (optimize)
matcher and the branch-and-bound coarse stage raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..models.grid_map import ProbMapSpec
from ..ops.correlative import (
    COARSE, FINE, SUPER, CorrelativeParams, correlative_scan_match,
)


@dataclasses.dataclass(frozen=True)
class MatcherParams:
    """Static 3-tier parameter bundle (ScanMatchParam,
    scan_matchers.h:39-158)."""

    coarse: CorrelativeParams
    fine: CorrelativeParams
    super_fine: CorrelativeParams
    use_optimize_scan_match: bool
    optimize_failed_cost: float
    use_fast_correlation_match: bool = False

    @staticmethod
    def from_config(config: SlamConfig, use_center_penalty: bool | None = None
                    ) -> "MatcherParams":
        if use_center_penalty is None:
            # center penalty disabled without odometry (slam_processor.cpp:739-741)
            use_center_penalty = config.use_odometry
        mk = lambda tier, size, res, aoff, ares, thr, pts: CorrelativeParams(
            search_space_size=size, search_space_resolution=res,
            search_angle_offset=aoff, search_angle_resolution=ares,
            response_threshold=thr, use_point_size=pts,
            use_center_penalty=use_center_penalty, tier=tier,
        )
        return MatcherParams(
            coarse=mk(COARSE, config.coarse_search_space_size,
                      config.coarse_search_space_resolution,
                      config.coarse_search_angle_offset,
                      config.coarse_search_angle_resolution,
                      config.coarse_response_threshold,
                      config.coarse_use_point_size),
            fine=mk(FINE, config.fine_search_space_size,
                    config.fine_search_space_resolution,
                    config.fine_search_angle_offset,
                    config.fine_search_angle_resolution,
                    config.fine_response_threshold,
                    config.fine_use_point_size),
            super_fine=mk(SUPER, config.super_fine_search_space_size,
                          config.super_fine_search_space_resolution,
                          config.super_fine_search_angle_offset,
                          config.super_fine_search_angle_resolution,
                          config.super_fine_response_threshold,
                          config.super_fine_use_point_size),
            use_optimize_scan_match=config.use_optimize_scan_match,
            optimize_failed_cost=config.optimize_failed_cost,
            use_fast_correlation_match=config.use_fast_correlation_match,
        )


class ScanMatchOutput(NamedTuple):
    pose: torch.Tensor       # (...,3) refined world pose
    score: torch.Tensor      # (...,) averaged stage score
    cov: torch.Tensor        # (...,3,3) covariance (fine positional + super angular)


def scan_match(params: MatcherParams,
               fine_spec: ProbMapSpec, fine_probs, fine_offset,
               coarse_spec: ProbMapSpec, coarse_probs, coarse_offset,
               points, mask, n_valid: int, init_pose,
               use_fine_scan_match: bool = True) -> ScanMatchOutput:
    """One full match (ScanMatchers::ScanMatch, scan_matchers.h:179-289).

    All correlative tiers run against the *fine* map (scan_matchers.h:238,
    249, 256). ``points`` are sensor-local meters; per-map scaling happens
    inside the ops. ``fine_probs`` / ``init_pose`` may carry leading batch
    dimensions (one per back-end chain)."""
    if params.use_optimize_scan_match:
        raise NotImplementedError(
            "use_optimize_scan_match: the Gauss-Newton matcher "
            "(ops/gauss_newton.py) is not ported yet")
    if params.use_fast_correlation_match:
        raise NotImplementedError(
            "use_fast_correlation_match: the branch-and-bound matcher "
            "(ops/branch_and_bound.py) is not ported yet")
    cov = torch.eye(3, dtype=torch.float32, device=fine_probs.device)

    res_c = correlative_scan_match(fine_spec, params.coarse, fine_probs,
                                   fine_offset, points, mask, n_valid,
                                   init_pose, cov)
    pose, score, cov = res_c.pose, res_c.response, res_c.cov
    times = 1

    if use_fine_scan_match:
        res_f = correlative_scan_match(fine_spec, params.fine, fine_probs,
                                       fine_offset, points, mask, n_valid,
                                       pose, cov)
        res_s = correlative_scan_match(fine_spec, params.super_fine, fine_probs,
                                       fine_offset, points, mask, n_valid,
                                       res_f.pose, res_f.cov)
        pose = res_s.pose
        score = score + res_f.response + res_s.response
        cov = res_s.cov
        times += 2

    return ScanMatchOutput(pose=pose, score=score / float(times), cov=cov)
