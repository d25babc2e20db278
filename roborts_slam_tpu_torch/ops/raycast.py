"""Map-consistency raycast check.

Counterpart of the JAX package's ``ops/raycast.py``
(``OccuGridMap::MapFeedbackResponsePenalty``, src/map/occu_grid_map.h:331-392
+ CheckOccuLineVisitorCallback :447-471): ray-trace a pose hypothesis
against the pub map and penalize rays that cross an occupied cell well
before their endpoint. On the card the bad-ray count comes from the CUDA
kernel (``ops/cuda/raycarve.cu``); ``bad_rays_plain`` is its plain version.
Both use the same integer cell rule and integer squared-distance test, so
they agree exactly. ``pose_world`` may carry leading batch dimensions (one
pose per back-end chain) against the one pub map.
"""

from __future__ import annotations

import math

import torch

from ..models.grid_map import CountMap, CountMapSpec, world_to_map_pose
from ..utils.geometry import transform_points
from .cuda.raycarve import bad_ray_count
from .raster import _cell_round


def _sample_beams(points, mask, n_valid: int, check_point_num: int):
    """Beam subsampling with the scan matcher's striding rule
    (occu_grid_map.h:362-369). ``n_valid`` is a host int."""
    use = check_point_num
    n_valid = int(n_valid)
    small = n_valid < 2 * use
    step = 1 if small else n_valid // max(use - 1, 1)
    max_samples = 2 * use
    sidx = torch.arange(max_samples, dtype=torch.int64, device=points.device) * step
    svalid = sidx < n_valid
    sidx = torch.clamp(sidx, 0, points.shape[0] - 1)
    svalid = svalid & mask[sidx]
    return sidx, svalid


def check_rays(spec: CountMapSpec, pose_map, points, mask, n_valid: int,
               check_point_num: int, bound_tolerance: float):
    """The rays ``map_feedback_penalty`` checks for poses in map
    coordinates ``pose_map (...,3)`` (``world_to_map_pose``):
    sensor cells ``start (...,2)``, endpoint cells ``end (...,S,2)`` of the
    subsampled beams, ``ray_ok (...,S)`` (a sampled valid beam whose endpoint
    lies inside the map and off the sensor's cell) and the integer
    squared-distance threshold ``thr_d2``."""
    sidx, svalid = _sample_beams(points, mask, n_valid, check_point_num)
    pts_map = transform_points(pose_map, points[sidx] * spec.inv_res)  # (...,S,2)
    end = _cell_round(pts_map)
    start = _cell_round(pose_map[..., :2])
    same = torch.all(end == start[..., None, :], dim=-1)
    end_in = ((end[..., 0] > 0) & (end[..., 0] < spec.width)
              & (end[..., 1] > 0) & (end[..., 1] < spec.height))
    # d > tol  <=>  d^2 >= floor(tol^2) + 1  (d^2 integer)
    thr_d2 = int(math.floor(bound_tolerance * bound_tolerance)) + 1
    return start, end, svalid & ~same & end_in, thr_d2


def map_feedback_penalty(spec: CountMapSpec, cmap: CountMap,
                         points, mask, n_valid: int, pose_world,
                         check_point_num: int, bound_tolerance: float,
                         penalty_gain: float,
                         min_passthrough: float, occu_threshold: float):
    """Returns the response coefficient in [0.1, 1+2*gain], shape ``(...)``
    for ``pose_world (...,3)``.

    Reference semantics: subsample ``check_point_num`` beams; a ray is "bad"
    (adds 1) if any visited cell is Occupied (pass >= min_passthrough and
    prob >= occu_threshold, grid_map_cell.h:125-136) at distance
    > bound_tolerance cells from the beam endpoint; coefficient =
    max(1 + 2*gain − gain·Σbad, 0.1) (occu_grid_map.h:388-389).
    """
    pose_map = world_to_map_pose(cmap.offset, spec.inv_res, pose_world)
    in_map = ((pose_map[..., 0] > 0) & (pose_map[..., 0] < spec.width)
              & (pose_map[..., 1] > 0) & (pose_map[..., 1] < spec.height))
    start, end, ray_ok, thr_d2 = check_rays(spec, pose_map, points, mask, n_valid,
                                            check_point_num, bound_tolerance)
    lead = pose_world.shape[:-1]
    S = ray_ok.shape[-1]
    bad_total = bad_ray_count(
        start.reshape(-1, 2).contiguous(), end.reshape(-1, S, 2).contiguous(),
        ray_ok.reshape(-1, S).contiguous(), cmap.hits, cmap.passes,
        min_passthrough, occu_threshold, thr_d2).reshape(lead)

    penalty = bad_total.to(torch.float32) * penalty_gain
    coeff = torch.clamp(1.0 + 2.0 * penalty_gain - penalty, min=0.1)
    return torch.where(in_map, coeff, 0.0)


def bad_rays_plain(start, end, ray_ok, hits, passes,
                   min_passthrough: float, occu_threshold: float, thr_d2: int):
    """Plain PyTorch version of the ray-check kernel, same arguments as
    ``ops.cuda.raycarve.bad_ray_count``: masked exact-integer DDA sample grid
    over (rays, steps) + gathers. start (B,2), end (B,S,2), ray_ok (B,S);
    returns (B,) int32."""
    H, W = hits.shape
    start = start.to(torch.int64)
    end = end.to(torch.int64)
    delta = end - start[:, None, :]                               # (B,S,2)
    nsteps = torch.clamp(torch.amax(torch.abs(delta), dim=-1), min=1)
    # steps up to the longest checked ray (endpoint included)
    T = int(torch.amax(torch.where(ray_ok, nsteps, 0))) + 1 if ray_ok.numel() else 1
    t = torch.arange(T, dtype=torch.int64, device=start.device)   # (T,)
    n2 = (2 * nsteps)[..., None, None]                            # (B,S,1,1)
    num = (n2 * start[:, None, None, :]
           + 2 * delta[:, :, None, :] * t[None, None, :, None]
           + nsteps[..., None, None])
    cells = torch.div(num, n2, rounding_mode="floor")             # (B,S,T,2)
    on_line = t[None, None, :] <= nsteps[..., None]

    cx = torch.clamp(cells[..., 0], 0, W - 1)
    cy = torch.clamp(cells[..., 1], 0, H - 1)
    p = passes[cy, cx]
    h = hits[cy, cx]
    prob = torch.where(p > 0, h / torch.clamp(p, min=1e-9), 0.5)
    occupied = (p >= min_passthrough) & (prob >= occu_threshold)

    d2 = torch.sum((cells - end[:, :, None, :]) ** 2, dim=-1)
    bad_cell = occupied & (d2 >= thr_d2) & on_line & ray_ok[..., None]
    return torch.sum(torch.any(bad_cell, dim=-1), dim=-1).to(torch.int32)
