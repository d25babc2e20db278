"""Front-end SLAM step.

Counterpart of the JAX package's ``frontend/processor.py``
(``SlamProcessor::process``, src/slam/slam_processor.cpp:65-247): predict →
3-tier match → map-consistency penalty → accept gate → map updates.

Differences from the JAX step, which is one jitted pure function whose
whole-map ``where(gate, new, old)`` selections are fused away and whose
buffers are donated:

- The step runs eagerly. Small state (pose, counters, last kept odometry)
  stays on the device as tensors and is gated with ``torch.where`` exactly
  as in JAX, so no value is fetched to decide it.
- The map-update gate is decided **once on the host**: the step fetches the
  packed ``(15,)`` summary (one synchronisation per scan — the same fetch
  the engine needs anyway) and, if the gate passed, updates the three maps
  **in place**. A rejected scan touches no map.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, make_count_map,
    make_prob_map, pub_map_spec, scan_match_map_specs,
)
from ..ops.raster import stamp_scan, update_count_map
from ..ops.raycast import map_feedback_penalty
from ..utils.geometry import pose_change_enough, predict_pose_by_odom
from .matchers import MatcherParams, scan_match


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    config: SlamConfig
    pub_spec: CountMapSpec
    coarse_spec: ProbMapSpec
    fine_spec: ProbMapSpec
    matcher: MatcherParams

    @staticmethod
    def from_config(config: SlamConfig, laser_range_max: float,
                    world_size: float | None = None) -> "FrontendSpec":
        if world_size is None:
            world_size = config.derived_world_size(laser_range_max)
        coarse, fine = scan_match_map_specs(
            config, world_size, coverage_m=laser_range_max + 2.0)
        return FrontendSpec(
            config=config,
            pub_spec=pub_map_spec(config, laser_range_max, world_size),
            coarse_spec=coarse,
            fine_spec=fine,
            matcher=MatcherParams.from_config(config),
        )

    def world_size(self) -> float:
        return self.pub_spec.height * self.pub_spec.resolution


@dataclasses.dataclass
class FrontendState:
    """Mutable front-end state: the three maps (updated in place) and the
    small device-resident scalars."""

    pub: CountMap
    coarse: ProbMap
    fine: ProbMap
    pose: torch.Tensor                  # (3,) current sensor pose (world)
    last_map_update_pose: torch.Tensor  # (3,)
    map_penalize_times: torch.Tensor    # () int32
    scan_index: torch.Tensor            # () int32 = current_data_index
    last_kept_odom: torch.Tensor        # (3,) odometry of the last KEPT scan


class StepInfo(NamedTuple):
    pose: torch.Tensor          # (3,) pose assigned to this scan
    score: torch.Tensor         # () penalized scan-match score
    cov: torch.Tensor           # (3,3)
    map_updated: torch.Tensor   # () bool — scan kept (added to store + backend)
    pose_accepted: torch.Tensor  # () bool — pose gate passed
    summary: np.ndarray         # (15,) float64 host copy of pack_step_summary


def pack_step_summary(pose, cov, map_updated, pose_accepted, score) -> torch.Tensor:
    """The step's results flattened to ONE (15,) f32 vector: pose(3) +
    cov(9) + [map_updated, pose_accepted, score] — the single per-scan
    fetch."""
    return torch.cat([
        pose.to(torch.float32),
        cov.reshape(-1).to(torch.float32),
        torch.stack([map_updated.to(torch.float32),
                     pose_accepted.to(torch.float32),
                     score.to(torch.float32)]),
    ])


def init_frontend_state(spec: FrontendSpec, device) -> FrontendState:
    """Maps centered on the start pose, reference map-offset convention
    (CreateAllMap, slam_processor.cpp:468-471: offset = init_map_size *
    map_offset_{x,y}, i.e. world origin at the map center). Offsets derive
    from each map's own extent."""
    cfg = spec.config
    f32 = dict(dtype=torch.float32, device=device)

    def off(mspec):
        ex = mspec.width * mspec.resolution
        ey = mspec.height * mspec.resolution
        return torch.tensor([ex * cfg.map_offset_x, ey * cfg.map_offset_y], **f32)
    return FrontendState(
        pub=make_count_map(spec.pub_spec, off(spec.pub_spec), device),
        coarse=make_prob_map(spec.coarse_spec, off(spec.coarse_spec), device),
        fine=make_prob_map(spec.fine_spec, off(spec.fine_spec), device),
        pose=torch.zeros(3, **f32),
        last_map_update_pose=torch.full((3,), 3.4e38, **f32),
        map_penalize_times=torch.zeros((), dtype=torch.int32, device=device),
        scan_index=torch.zeros((), dtype=torch.int32, device=device),
        last_kept_odom=torch.zeros(3, **f32),
    )


def frontend_step(spec: FrontendSpec, state: FrontendState,
                  points, mask, n_valid: int, cur_odom
                  ) -> tuple[FrontendState, StepInfo]:
    """One scan through the front end (slam_processor.cpp:65-247), matching
    against the accumulated scan-match maps. Mutates ``state`` (maps in
    place, scalars replaced) and returns it with the step's ``StepInfo``."""
    cfg = spec.config
    is_first = state.scan_index == 0

    # --- predict (slam_processor.cpp:122-126) ---
    if cfg.use_odometry:
        # first scan: no kept odom yet -> zero delta
        last_odom = torch.where(is_first, cur_odom, state.last_kept_odom)
        predict = predict_pose_by_odom(state.pose, last_odom, cur_odom)
    else:
        predict = state.pose

    # --- scan match (:133-149) ---
    out = scan_match(
        spec.matcher,
        spec.fine_spec, state.fine.probs, state.fine.offset,
        spec.coarse_spec, state.coarse.probs, state.coarse.offset,
        points, mask, n_valid, predict,
    )

    # --- map-consistency penalty (:167-178, MapCheckPenalize :573-595) ---
    if cfg.use_map_check_feedback:
        penalty = map_feedback_penalty(
            spec.pub_spec, state.pub, points, mask, n_valid, out.pose,
            cfg.map_check_point_num, cfg.map_check_bound_tolerance,
            cfg.map_check_penalty_gain,
            min_passthrough=cfg.map_min_passthrough,
            occu_threshold=cfg.map_occu_threshold,
        )
    else:
        penalty = torch.ones((), dtype=torch.float32, device=points.device)

    apply_pen = state.map_penalize_times < 5
    score = torch.where(apply_pen,
                        torch.clamp(out.score * penalty, max=1.0), out.score)
    pen_times = torch.where(
        apply_pen,
        torch.where(penalty < 0.7, state.map_penalize_times + 1, 0),
        0,
    )

    # --- pose accept gate (:182-186) ---
    accept = score > max(0.5, cfg.map_update_score_threshold)
    pose = torch.where(is_first, state.pose,
                       torch.where(accept, out.pose, state.pose))
    score = torch.where(is_first, 1.0, score)

    # --- map update gate (UpdateMap, slam_processor.cpp:529-571) ---
    moved = pose_change_enough(pose, state.last_map_update_pose,
                               cfg.map_update_distance_threshold,
                               cfg.map_update_angle_threshold)
    gate = score > cfg.map_update_score_threshold
    if cfg.use_map_update_move_check:
        gate = gate & moved
    gate = gate | (state.scan_index < 1) | is_first

    # pub map factors: the first scan is trusted (slam_processor.cpp:540-552)
    free_f = torch.where(is_first, float(cfg.map_min_passthrough),
                         float(cfg.map_update_free_factor))
    occu_f = torch.where(is_first, float(cfg.map_min_passthrough * 2.0),
                         float(cfg.map_update_occu_factor))

    pose_accepted = accept | is_first
    # the one host synchronisation of the step: the packed summary carries
    # the gate that decides the in-place map updates
    summary = pack_step_summary(pose, out.cov, gate, pose_accepted, score) \
        .cpu().numpy().astype(np.float64)
    if summary[12] > 0.5:
        update_count_map(spec.pub_spec, state.pub, points, mask, pose,
                         free_f, occu_f)
        stamp_scan(spec.coarse_spec, state.coarse, points, mask, pose,
                   use_blur=cfg.coarse_map_use_blur)
        stamp_scan(spec.fine_spec, state.fine, points, mask, pose,
                   use_blur=cfg.fine_map_use_blur)

    state.pose = pose
    state.last_map_update_pose = torch.where(gate, pose,
                                             state.last_map_update_pose)
    state.map_penalize_times = torch.where(is_first, 0, pen_times).to(torch.int32)
    state.scan_index = state.scan_index + gate.to(torch.int32)
    # the engine keeps a scan (and its odom) iff the map-update gate passed
    state.last_kept_odom = torch.where(gate, cur_odom.to(torch.float32),
                                       state.last_kept_odom)
    info = StepInfo(pose=pose, score=score, cov=out.cov, map_updated=gate,
                    pose_accepted=pose_accepted, summary=summary)
    return state, info
