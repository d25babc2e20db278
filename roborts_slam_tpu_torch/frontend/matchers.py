"""Tiered scan-match facade.

Counterpart of the JAX package's ``frontend/matchers.py`` (``ScanMatchers``,
src/scan_match/scan_matchers.h:160-416): optional Gauss-Newton refinement,
coarse→fine→super-fine correlative passes, all on the fine map
(scan_matchers.h:238-260), stage-score averaging (:281) and the per-tier
parameter derivation (ScanMatchParamInit :307-355).

The Gauss-Newton stage (``ops/gauss_newton.py``) takes one of two device
paths: on the card every pass of it is one launch of the CUDA kernel K6
(``ops/cuda/gauss_newton.cu``), a block a map, inside the captured step and
chain-batch programs; on CPU tensors it is the plain PyTorch loop. The
data-dependent "optimize failed → fall back to coarse correlative" branch
(:224-242), a ``lax.cond`` in the JAX package, is computed on both sides and
selected with ``torch.where``: under the chain batch the JAX ``cond`` is per
element anyway, and the single front-end match keeps its one host read per
scan this way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..models.grid_map import ProbMapSpec
from ..ops.branch_and_bound import BnBParams, bnb_scan_match
from ..ops.correlative import (
    COARSE, FINE, SUPER, CorrelativeParams, correlative_scan_match, valid_count,
)
from ..ops.gauss_newton import OptimizeParams, optimize_scan_match


@dataclasses.dataclass(frozen=True)
class MatcherParams:
    """Static 3-tier + optimizer parameter bundle (ScanMatchParam,
    scan_matchers.h:39-158)."""

    coarse: CorrelativeParams
    fine: CorrelativeParams
    super_fine: CorrelativeParams
    optimize: OptimizeParams
    use_optimize_scan_match: bool
    optimize_failed_cost: float
    # branch-and-bound replacement for the coarse stage (None = disabled);
    # the reference's FAST_CORRELATION_SCAN_MATCH (scan_matchers.h:266-273)
    bnb: BnBParams | None = None

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
            optimize=OptimizeParams(
                iterate_max_times=config.iterate_times,
                cost_decrease_threshold=config.cost_decrease_threshold,
                cost_min_threshold=config.cost_min_threshold,
                max_update_distance=config.max_update_distance,
                max_update_angle=config.max_update_angle,
            ),
            use_optimize_scan_match=config.use_optimize_scan_match,
            optimize_failed_cost=config.optimize_failed_cost,
            bnb=(_bnb_params(config)
                 if config.use_fast_correlation_match else None),
        )


def _bnb_params(config: SlamConfig) -> BnBParams:
    return BnBParams(
        search_space_size=config.fast_match_space_size,
        search_space_resolution=config.fast_match_space_resolution,
        search_angle_offset=config.fast_match_angle_offset,
        search_angle_resolution=config.fast_match_angle_resolution,
        response_threshold=config.fast_match_response_threshold,
        use_point_size=config.fast_match_use_point_size,
        max_depth=config.fast_match_max_depth,
        beam_width=config.fast_match_beam_width,
    )


class ScanMatchOutput(NamedTuple):
    pose: torch.Tensor       # (...,3) refined world pose
    score: torch.Tensor      # (...,) averaged stage score
    cov: torch.Tensor        # (...,3,3) covariance (fine positional + super angular)
    # (...,2) f32: the Gauss-Newton stage's passes and whether its cost
    # failed (the coarse tier's pose taken); zeros where it did not run
    gn: torch.Tensor


def _bnb_coarse(params: BnBParams, fine_spec: ProbMapSpec, fine_probs,
                fine_offset, points, mask, n_valid, start_pose):
    """The branch-and-bound coarse stage for maps with any leading batch
    dims: one ``bnb_scan_match`` per map (a Python loop where the JAX package
    ``vmap``s). Returns (pose (...,3), response (...,))."""
    lead = fine_probs.shape[:-2]
    if not lead:
        res = bnb_scan_match(fine_spec, params, fine_probs, fine_offset,
                             points, mask, n_valid, start_pose)
        return res.pose, res.response
    B = math.prod(lead)
    maps = fine_probs.reshape(B, *fine_probs.shape[-2:])
    offs = fine_offset.expand(*lead, 2).reshape(B, 2)
    starts = start_pose.expand(*lead, 3).reshape(B, 3)
    out = [bnb_scan_match(fine_spec, params, maps[i], offs[i], points, mask,
                          n_valid, starts[i]) for i in range(B)]
    return (torch.stack([r.pose for r in out]).reshape(*lead, 3),
            torch.stack([r.response for r in out]).reshape(lead))


def scan_match(params: MatcherParams,
               fine_spec: ProbMapSpec, fine_probs, fine_offset,
               coarse_spec: ProbMapSpec, coarse_probs, coarse_offset,
               points, mask, n_valid, init_pose,
               use_fine_scan_match: bool = True) -> ScanMatchOutput:
    """One full match (ScanMatchers::ScanMatch, scan_matchers.h:179-289).

    All correlative tiers run against the *fine* map (scan_matchers.h:238,
    249, 256); the optimizer runs against the coarse map (:207), which is
    read only when ``params.use_optimize_scan_match`` is set: by K6 on the
    card, by the plain loop on CPU tensors (module docstring); the output's
    ``gn`` carries its passes and failed flag, for the engine's counters.
    ``points`` are
    sensor-local meters; per-map scaling happens inside the ops. The maps,
    offsets and ``init_pose`` may carry leading batch dimensions (one per
    back-end chain). ``n_valid``: a () int tensor on the device (a host int
    is made one), so that nothing here reads the host."""
    n_valid = valid_count(n_valid, fine_probs.device)
    cov = torch.eye(3, dtype=torch.float32, device=fine_probs.device)

    def run_coarse(start_pose, cov_in):
        if params.bnb is not None:
            # FAST_CORRELATION_SCAN_MATCH stage (scan_matchers.h:266-273):
            # branch-and-bound over max-pooled bounds replaces the dense
            # coarse sweep; covariance stays cov_in — with the fine passes
            # on, the fine/super tiers rewrite it anyway (:247-261)
            pose, resp = _bnb_coarse(params.bnb, fine_spec, fine_probs,
                                     fine_offset, points, mask, n_valid,
                                     start_pose)
            return (pose, torch.clamp(resp, max=1.0),
                    cov_in.expand(*resp.shape, 3, 3))
        res = correlative_scan_match(fine_spec, params.coarse, fine_probs,
                                     fine_offset, points, mask, n_valid,
                                     start_pose, cov_in)
        return res.pose, res.response, res.cov

    pose, score, cov = run_coarse(init_pose, cov)
    gn = torch.zeros((*score.shape, 2), dtype=torch.float32, device=score.device)
    if params.use_optimize_scan_match and use_fine_scan_match:
        # the coarse block is entered only on optimize failure (:224-226),
        # where the optimize result is discarded (:228-234): both sides end
        # with exactly one stage score recorded. Without the fine passes the
        # reference enters the coarse block unconditionally, discarding even
        # a successful optimize result (:224-234) — that quirk is the plain
        # ``run_coarse`` above, and the optimizer need not run at all.
        opt = optimize_scan_match(coarse_spec, params.optimize, coarse_probs,
                                  coarse_offset, points, mask, init_pose)
        opt_score = params.optimize_failed_cost / (
            opt.cost + params.optimize_failed_cost)
        failed = opt.cost > params.optimize_failed_cost
        gn = torch.stack([opt.passes.to(torch.float32), failed.to(torch.float32)], -1)
        pose = torch.where(failed[..., None], pose, opt.pose)
        score = torch.where(failed, score, opt_score)
        cov = torch.where(failed[..., None, None], cov,
                          torch.eye(3, dtype=torch.float32, device=cov.device))
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

    return ScanMatchOutput(pose=pose, score=score / float(times), cov=cov, gn=gn)
