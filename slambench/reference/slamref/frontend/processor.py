"""Front-end SLAM step.

Counterpart of the JAX package's ``frontend/processor.py``
(``SlamProcessor::process``, src/slam/slam_processor.cpp:65-247): predict →
tiered match → map-consistency penalty → accept gate → map updates.

Differences from the JAX step, which is one jitted pure function whose
whole-map ``where(gate, new, old)`` selections are fused away and whose
buffers are donated:

- The step writes its state in place, the counterpart of donation: the maps
  and the small state (pose, counters, last kept odometry) keep their
  tensors, so a step captured in a CUDA graph (``step_graph.py``) reads
  and writes the same memory on every replay. The small state is gated with
  ``torch.where`` exactly as in JAX, so no value is fetched to decide it;
  ``n_valid`` is a device scalar (a host int is made one).
- The blocking step decides the map-update gate **once on the host**: it
  fetches the packed ``(15,)`` summary (one synchronisation per scan — the
  same fetch the engine needs anyway) and, if the gate passed, updates the
  three maps **in place**. A rejected scan touches no map.
- The device-gated step (``device_gate=True``: the fused and pipelined
  steps of ``backend/processor.py``) reads nothing: the three updates always
  run, in place, and the gate tensor zeroes the count increments and drops
  the stamps where it is false (``ops/raster.py``), which leaves the maps'
  bits as they were — the JAX step's ``where(gate, new, old)`` without a
  whole-map select. Its summary stays on the device for the caller.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, backend_map_specs,
    make_count_map, make_prob_map, pub_map_spec, scan_match_map_specs,
)
from ..ops.correlative import valid_count
from ..ops.raster import stamp_scan, stamp_scan_batch, update_count_map
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
    # windowed-match map specs (use_running_range_scan_match): sized like the
    # back-end chain maps, rebuilt from the running window around each scan
    window_coarse_spec: ProbMapSpec | None = None
    window_fine_spec: ProbMapSpec | None = None

    @staticmethod
    def from_config(config: SlamConfig, laser_range_max: float,
                    world_size: float | None = None) -> "FrontendSpec":
        if world_size is None:
            world_size = config.derived_world_size(laser_range_max)
        coarse, fine = scan_match_map_specs(
            config, world_size, coverage_m=laser_range_max + 2.0)
        wcoarse = wfine = None
        if config.use_running_range_scan_match:
            wcoarse, wfine = backend_map_specs(config, laser_range_max)
        return FrontendSpec(
            config=config,
            pub_spec=pub_map_spec(config, laser_range_max, world_size),
            coarse_spec=coarse,
            fine_spec=fine,
            matcher=MatcherParams.from_config(config),
            window_coarse_spec=wcoarse,
            window_fine_spec=wfine,
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
    # time (relative to the engine's first stamp) of the last scan that
    # passed the move gate: the device-side MoveEnough check of a step given
    # ``cur_time`` reads it (the pipelined step dispatches ahead of the host)
    last_step_time: torch.Tensor        # () f32


class StepInfo(NamedTuple):
    pose: torch.Tensor          # (3,) pose assigned to this scan
    score: torch.Tensor         # () penalized scan-match score
    cov: torch.Tensor           # (3,3)
    map_updated: torch.Tensor   # () bool — scan kept (added to store + backend)
    pose_accepted: torch.Tensor  # () bool — pose gate passed
    packed: torch.Tensor        # (15,) f32 on the device, pack_step_summary
    summary: np.ndarray | None  # its float64 host copy (None: device-gated step)


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
        last_step_time=torch.full((), -3.4e38, **f32),
    )


def frontend_step(spec: FrontendSpec, state: FrontendState,
                  points, mask, n_valid, cur_odom, cur_time=None,
                  device_gate: bool = False) -> tuple[FrontendState, StepInfo]:
    """One scan through the front end (slam_processor.cpp:65-247), matching
    against the accumulated scan-match maps. Writes ``state`` in place (maps
    and scalars keep their tensors) and returns it with the step's
    ``StepInfo``. ``n_valid``: a () int tensor on the device, or a host int.
    ``cur_time`` (a () f32 tensor, seconds since the engine's first stamp)
    adds the MoveEnough gate on the device against the last kept odometry
    and ``state.last_step_time``. ``device_gate``: update the maps under the
    gate on the device and read nothing (see the module docstring)."""
    return _frontend_core(
        spec, state,
        spec.fine_spec, state.fine, spec.coarse_spec, state.coarse,
        points, mask, n_valid, cur_odom, cur_time, device_gate)


def _predict(spec: FrontendSpec, state: FrontendState, cur_odom):
    """Odometry prediction of this scan's pose (slam_processor.cpp:122-126)."""
    if not spec.config.use_odometry:
        return state.pose
    # first scan: no kept odom yet -> zero delta
    last_odom = torch.where(state.scan_index == 0, cur_odom,
                            state.last_kept_odom)
    return predict_pose_by_odom(state.pose, last_odom, cur_odom)


def frontend_step_windowed(spec: FrontendSpec, state: FrontendState,
                           win_points, win_masks, win_poses, win_valid,
                           points, mask, n_valid, cur_odom
                           ) -> tuple[FrontendState, StepInfo]:
    """Windowed variant (use_running_range_scan_match): the match maps are
    rebuilt from the running-range window scans ``win_* (W, ...)``,
    recentered on the odometry prediction — the reference's disabled
    windowed path (slam_processor.cpp:134-159) built the same maps via
    ResetScanMatchMapWithRangeVec (:448-462). The persistent maps are still
    updated normally afterwards (UpdateMap runs on all maps either way). The
    coarse window map is read by the optimize matcher only and is built only
    for it."""
    cfg = spec.config
    predict = _predict(spec, state, cur_odom)

    def window_map(pspec: ProbMapSpec, use_blur: bool) -> ProbMap:
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = torch.stack([-(predict[0] - 0.5 * size_x),
                           -(predict[1] - 0.5 * size_y)])
        return stamp_scan_batch(pspec, make_prob_map(pspec, off, off.device),
                                win_points, win_masks, win_poses, win_valid,
                                use_blur=use_blur)

    wfine = window_map(spec.window_fine_spec, cfg.fine_map_use_blur)
    wcoarse = ProbMap(None, None)
    if spec.matcher.use_optimize_scan_match:
        wcoarse = window_map(spec.window_coarse_spec, cfg.coarse_map_use_blur)
    return _frontend_core(
        spec, state,
        spec.window_fine_spec, wfine, spec.window_coarse_spec, wcoarse,
        points, mask, n_valid, cur_odom, None)


def _frontend_core(spec: FrontendSpec, state: FrontendState,
                   match_fine_spec: ProbMapSpec, match_fine: ProbMap,
                   match_coarse_spec: ProbMapSpec, match_coarse: ProbMap,
                   points, mask, n_valid, cur_odom, cur_time=None,
                   device_gate: bool = False) -> tuple[FrontendState, StepInfo]:
    """Shared front-end step: predict → match (against the given maps) →
    penalty → gates → persistent map updates. With ``cur_time`` the
    MoveEnough gate (slam_processor.cpp:604-616) also runs on the device
    against the last kept odometry: a move-gated scan changes nothing."""
    cfg = spec.config
    n_valid = valid_count(n_valid, points.device)
    is_first = state.scan_index == 0
    move_ok = None
    if cur_time is not None and cfg.use_odometry and cfg.use_move_check:
        dt_pass = (cur_time - state.last_step_time) > cfg.move_time_threshold
        d = cur_odom[:2] - state.last_kept_odom[:2]
        dist_pass = torch.hypot(d[0], d[1]) >= cfg.move_distance_threshold
        dth = cur_odom[2] - state.last_kept_odom[2]
        ang_pass = torch.abs(torch.atan2(torch.sin(dth), torch.cos(dth))) \
            >= cfg.move_angle_threshold
        move_ok = is_first | dt_pass | dist_pass | ang_pass
    predict = _predict(spec, state, cur_odom)

    # --- scan match (:133-149) ---
    out = scan_match(
        spec.matcher,
        match_fine_spec, match_fine.probs, match_fine.offset,
        match_coarse_spec, match_coarse.probs, match_coarse.offset,
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

    # --- pose accept gate (:182-186); a move-gated scan changes nothing ---
    accept = score > max(0.5, cfg.map_update_score_threshold)
    if move_ok is not None:
        accept = accept & move_ok
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
    gate = gate | (state.scan_index < 1)
    if move_ok is not None:
        gate = gate & move_ok
    gate = gate | is_first

    # pub map factors: the first scan is trusted (slam_processor.cpp:540-552)
    free_f = torch.where(is_first, float(cfg.map_min_passthrough),
                         float(cfg.map_update_free_factor))
    occu_f = torch.where(is_first, float(cfg.map_min_passthrough * 2.0),
                         float(cfg.map_update_occu_factor))

    pose_accepted = accept | is_first
    packed = pack_step_summary(pose, out.cov, gate, pose_accepted, score)
    summary = None
    if device_gate:
        update_count_map(spec.pub_spec, state.pub, points, mask, pose,
                         free_f, occu_f, gate=gate)
        stamp_scan(spec.coarse_spec, state.coarse, points, mask, pose,
                   use_blur=cfg.coarse_map_use_blur, gate=gate)
        stamp_scan(spec.fine_spec, state.fine, points, mask, pose,
                   use_blur=cfg.fine_map_use_blur, gate=gate)
    else:
        # the one host synchronisation of the blocking step: the packed
        # summary carries the gate that decides the in-place map updates
        summary = packed.cpu().numpy().astype(np.float64)
        if summary[12] > 0.5:
            update_count_map(spec.pub_spec, state.pub, points, mask, pose,
                             free_f, occu_f)
            stamp_scan(spec.coarse_spec, state.coarse, points, mask, pose,
                       use_blur=cfg.coarse_map_use_blur)
            stamp_scan(spec.fine_spec, state.fine, points, mask, pose,
                       use_blur=cfg.fine_map_use_blur)

    # the state written in place (JAX donates it)
    state.last_map_update_pose.copy_(torch.where(gate, pose, state.last_map_update_pose))
    if move_ok is not None:
        pen_times = torch.where(move_ok, pen_times, state.map_penalize_times)
        state.last_step_time.copy_(torch.where(move_ok, cur_time.to(torch.float32),
                                               state.last_step_time))
    state.map_penalize_times.copy_(torch.where(is_first, 0, pen_times))
    state.scan_index.add_(gate.to(torch.int32))
    # the engine keeps a scan (and its odom) iff the map-update gate passed
    state.last_kept_odom.copy_(torch.where(gate, cur_odom.to(torch.float32),
                                           state.last_kept_odom))
    state.pose.copy_(pose)
    info = StepInfo(pose=pose, score=score, cov=out.cov, map_updated=gate,
                    pose_accepted=pose_accepted, packed=packed, summary=summary)
    return state, info
