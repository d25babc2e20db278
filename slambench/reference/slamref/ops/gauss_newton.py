"""Gauss-Newton scan-to-map refinement (optimize matcher).

Counterpart of the JAX package's ``ops/gauss_newton.py``
(``BasedOptimizeScanMatch``, src/scan_match/optimize_scan_matcher.h:60-237):
per-point bilinear interpolation + analytic Jacobian accumulation (:154-221)
vectorized over all points, and the early-stopping iteration (:86-124).

Differences from the JAX module:

- ``lax.while_loop`` becomes a fixed loop of ``iterate_max_times`` steps
  that carries a ``done`` mask on the device: an element that has stopped
  keeps its pose and cost, exactly what a batched ``while_loop`` does under
  ``vmap``. No value is read on the host.
- The 3x3 normal equations are solved by Gaussian elimination with partial
  pivoting written out in tensor ops (``solve3``), not by
  ``torch.linalg.solve``: the library call synchronises for its error check
  and raises on a singular matrix, where the JAX solve returns NaN/inf and
  the caller turns that into "keep the pose, cost ``K_MAX_COST``".
- Maps, offsets and poses may carry leading batch dimensions (one per
  back-end chain); the scan is shared by the batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose
from ..utils.geometry import normalize_angle

K_COST_POINT_SIZE = 1000.0   # optimize_scan_matcher.h:234
K_MAX_COST = 1000.0          # optimize_scan_matcher.h:235


@dataclasses.dataclass(frozen=True)
class OptimizeParams:
    """OptimizeScanMatchParam (optimize_scan_matcher.h:33-58)."""

    iterate_max_times: int
    cost_decrease_threshold: float
    cost_min_threshold: float
    max_update_distance: float
    max_update_angle: float


class OptimizeResult(NamedTuple):
    pose: torch.Tensor   # (...,3) world
    cost: torch.Tensor   # (...,) normalized cost


def solve3(H, b):
    """Solve the 3x3 systems ``H x = b`` (H (...,3,3), b (...,3)) by Gaussian
    elimination with partial pivoting (first largest pivot, as LAPACK's
    ``getrf`` picks it) and back substitution, in plain tensor ops. A zero
    pivot is divided by: a singular ``H`` yields NaN or inf, never an
    exception and never a host read."""
    M = torch.cat([H, b[..., None]], dim=-1)                  # (...,3,4)
    rows = torch.arange(3, device=M.device)
    for k in range(2):
        p = torch.argmax(torch.abs(M[..., k:, k]), dim=-1, keepdim=True) + k
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        M = torch.gather(M, -2, perm[..., None].expand(M.shape))
        factor = M[..., k + 1:, k] / M[..., k:k + 1, k]        # (...,2-k)
        lower = M[..., k + 1:, :] - factor[..., None] * M[..., k:k + 1, :]
        M = torch.cat([M[..., :k + 1, :], lower], dim=-2)
    x2 = M[..., 2, 3] / M[..., 2, 2]
    x1 = (M[..., 1, 3] - M[..., 1, 2] * x2) / M[..., 1, 1]
    x0 = (M[..., 0, 3] - M[..., 0, 1] * x1 - M[..., 0, 2] * x2) / M[..., 0, 0]
    return torch.stack([x0, x1, x2], dim=-1)


def _cost_h_b(spec: ProbMapSpec, probs, pose_map, points, mask):
    """One UpdateCost pass (optimize_scan_matcher.h:154-221): bilinear map
    interpolation, residual 1-p, analytic Jacobian, accumulate H, b.
    probs (...,H,W), pose_map (...,3); points (P,2), mask (P,) shared.
    Returns cost (...,), H (...,3,3), b (...,3)."""
    inv_res = spec.inv_res
    lead = pose_map.shape[:-1]
    c = torch.cos(pose_map[..., 2:3])
    s = torch.sin(pose_map[..., 2:3])
    local = points * inv_res                            # (P,2) map units
    lx, ly = local[:, 0], local[:, 1]
    mx = c * lx - s * ly + pose_map[..., 0:1]           # (...,P)
    my = s * lx + c * ly + pose_map[..., 1:2]

    # strict comparisons on the float coordinates (:162-165)
    in_map = (mx > 0) & (mx < spec.width) & (my > 0) & (my < spec.height) & mask

    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    x1 = x0 + 1.0
    y1 = y0 + 1.0

    flat = probs.expand(*lead, spec.height, spec.width).reshape(
        *lead, spec.height * spec.width)

    def at(xi, yi):
        # cast first, clamp after, as the JAX module does
        xi_i = torch.clamp(xi.to(torch.int32), 0, spec.width - 1).to(torch.int64)
        yi_i = torch.clamp(yi.to(torch.int32), 0, spec.height - 1).to(torch.int64)
        return torch.gather(flat, -1, yi_i * spec.width + xi_i)

    p00, p01 = at(x0, y0), at(x0, y1)
    p10, p11 = at(x1, y0), at(x1, y1)

    resp = ((my - y0) * (p11 * (mx - x0) + p01 * (x1 - mx))
            + (y1 - my) * (p10 * (mx - x0) + p00 * (x1 - mx)))
    resp = torch.clamp(resp, 0.0, 1.0)
    err = torch.where(in_map, 1.0 - resp, 0.0)

    # d(residual)/d(pose): J = -de_m * de_s (:196-210)
    dmx = (my - y0) * (p11 - p01) + (y1 - my) * (p10 - p00)
    dmy = (mx - x0) * (p11 - p10) + (x1 - mx) * (p01 - p00)
    dsx_th = -s * lx - c * ly
    dsy_th = c * lx - s * ly
    J = torch.stack([-dmx, -dmy, -(dmx * dsx_th + dmy * dsy_th)], dim=-1)  # (...,P,3)
    J = torch.where(in_map[..., None], J, 0.0)

    H = J.transpose(-1, -2) @ J
    b = -(J.transpose(-1, -2) @ err[..., None])[..., 0]
    cost = torch.sum(err * err, dim=-1)
    valid = 1 + torch.sum(in_map.to(torch.int32), dim=-1)    # starts at 1 (:160)
    cost = cost * (K_COST_POINT_SIZE / valid.to(torch.float32))
    return cost, H, b


def optimize_scan_match(spec: ProbMapSpec, params: OptimizeParams,
                        probs, offset, points, mask, pose_world) -> OptimizeResult:
    """Iterated GN with step clamping and plateau early-stop
    (optimize_scan_matcher.h:86-132)."""
    pose0 = world_to_map_pose(offset, spec.inv_res, pose_world)
    max_d = params.max_update_distance * spec.inv_res
    lead = pose0.shape[:-1]
    dev = pose0.device
    eye = 1e-9 * torch.eye(3, dtype=torch.float32, device=dev)
    # the step's lower clamp, written by fills (a copy from host memory
    # would wait for the device and cannot be captured)
    lo = torch.full((3,), -max_d, dtype=torch.float32, device=dev)
    lo[2:].fill_(-params.max_update_angle)

    pose = pose0
    cost = torch.zeros(lead, dtype=torch.float32, device=dev)   # start cost 0
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    for it in range(params.iterate_max_times):
        last = cost
        new_cost, H, b = _cost_h_b(spec, probs, pose, points, mask)
        det = solve3(H + eye, b)
        nan = torch.any(torch.isnan(det), dim=-1)
        stop = nan
        if it > 0:      # the first pass has no previous cost to compare with
            stop = nan | (last - new_cost < params.cost_decrease_threshold) \
                | (new_cost < params.cost_min_threshold)
        step = torch.maximum(torch.minimum(det, -lo), lo)
        new_pose = torch.where(stop[..., None], pose, pose + step)
        out_cost = torch.where(nan, K_MAX_COST, new_cost)
        # an element that stopped earlier keeps what it had
        pose = torch.where(done[..., None], pose, new_pose)
        cost = torch.where(done, cost, out_cost)
        done = done | stop
    # empty-scan guard (optimize_scan_matcher.h:73-76): max cost, keep pose
    empty = ~torch.any(mask)
    cost = torch.where(empty, K_MAX_COST, cost)
    pose = torch.where(empty, pose0, pose)
    pose = torch.cat([pose[..., :2], normalize_angle(pose[..., 2:3])], dim=-1)
    return OptimizeResult(pose=map_to_world_pose(offset, spec.inv_res, pose),
                          cost=cost)
