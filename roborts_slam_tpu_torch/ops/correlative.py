"""Batched correlative scan matching — the engine's hot path.

Counterpart of the JAX package's ``ops/correlative.py`` (the reference's
serial Olson-style triple loop, correlate_scan_matcher.h:505-1036). All
(angle, x, y) candidates of a tier are scored at once:

  1. rotate the subsampled scan points for every search angle;
  2. sum the map probability under every (angle, sample, x, y) candidate
     cell — on the card this is one of the two hand-written CUDA kernels
     (``ops/cuda/correlation.cu``, ``correlation_v2.cu``), on CPU tensors
     the gather below;
  3. center penalty, tie-averaged best pose, and positional/angular
     covariance as vectorized postprocessing.

Where the JAX package maps a single-match function over chains with
``vmap``, every function here is written batch-polymorphic: maps, offsets
and poses may carry leading batch dimensions ``(...)`` (one per back-end
chain); the scan (``points``, ``mask``, ``n_valid``) is shared by the batch.
``n_valid`` is a host ``int`` — the engine always knows it — so the point
subsampling rule costs no device work and no synchronisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose
from .xla_rounding import angle_ramp, candidate_offsets, tie_sums

# constants from correlate_scan_matcher.h:759-763, 1033 and slam_util.h:57-59
K_ANGULAR_PENALTY_GAIN = 0.25
K_DISTANCE_PENALTY_GAIN_COARSE = 0.4
K_DISTANCE_PENALTY_GAIN_FINE = 0.2
K_RESPONSE_FILTER_TOLERANCE = 1e-2
K_MAX_VARIANCE = 500.0
K_DOUBLE_TOLERANCE = 1e-6
K_MAX_VARIANCE_USE_POINT_SIZE = 20

COARSE, FINE, SUPER = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class CorrelativeParams:
    """Static search-grid configuration for one tier
    (CorrelationScanMatchParam, correlate_scan_matcher.h:41-86)."""

    search_space_size: float
    search_space_resolution: float
    search_angle_offset: float
    search_angle_resolution: float
    response_threshold: float
    use_point_size: int
    use_center_penalty: bool
    tier: int  # COARSE / FINE / SUPER

    @property
    def n_angles(self) -> int:
        # correlate_scan_matcher.h:154
        return int(math.floor(self.search_angle_offset * 2 / self.search_angle_resolution) + 1)

    @property
    def n_space(self) -> int:
        # correlate_scan_matcher.h:538 (util::Round = round-half-away)
        return int(round(self.search_space_size / self.search_space_resolution) + 1)

    @property
    def max_samples(self) -> int:
        # static bound on subsampled point count (see _sample_indices)
        return 2 * self.use_point_size


class MatchResult(NamedTuple):
    pose: torch.Tensor        # (...,3) world pose (updated iff response > threshold)
    response: torch.Tensor    # (...,) clamped to <= 1
    cov: torch.Tensor         # (...,3,3) this tier's covariance writes applied
    best_map_pose: torch.Tensor  # (...,3) best candidate in map coords (debug)


class CandidateGrid(NamedTuple):
    """Everything the scoring sum needs, computed once in torch so the CUDA
    kernel and the plain version see the same floats."""

    rx: torch.Tensor        # (..., A, S) rotated sample x (map cells, local)
    ry: torch.Tensor        # (..., A, S)
    svalid: torch.Tensor    # (S,) bool — sample within the scan's valid points
    divisor: float          # score divisor (use_point_size or n_valid)
    angles: torch.Tensor    # (..., A)
    xs: torch.Tensor        # (..., N) candidate sensor x (map cells)
    ys: torch.Tensor        # (..., N)


def _sample_indices(n_valid: int, use_point_size: int, max_samples: int,
                    device):
    """Reference point-subsampling rule (correlate_scan_matcher.h:560-566):
    step = P // (use-1) when P >= 2*use else 1; iterate i*step < P; the score
    divisor is use (or P when P < 2*use) even if the sample count differs.
    Returns (idx (S,) int64, valid (S,) bool, divisor float)."""
    use = use_point_size
    n_valid = int(n_valid)
    small = n_valid < 2 * use
    step = 1 if small else n_valid // max(use - 1, 1)
    idx = torch.arange(max_samples, dtype=torch.int64, device=device) * step
    valid = idx < n_valid
    divisor = float(max(n_valid if small else use, 1))
    return idx, valid, divisor


def candidate_grid(spec: ProbMapSpec, params: CorrelativeParams,
                   points, n_valid: int, center_pose_map,
                   center_m=None) -> CandidateGrid:
    """Search angles, rotated samples and candidate offsets of one tier,
    in the operation order of the JAX package's ``score_candidates``.
    ``center_m``: the centre's world position plus the map offset (...,
    2), in metres, where the centre was mapped from a world pose in the
    same step; the candidate offsets are then rounded as the JAX package's
    compiled step rounds them (``xla_rounding.candidate_offsets``), else
    as the source reads, from ``center_pose_map``."""
    A, N = params.n_angles, params.n_space
    inv_res = spec.inv_res
    dev = center_pose_map.device

    # search angles (correlate_scan_matcher.h:159-164)
    base_angle = center_pose_map[..., 2:3]
    start_angle = base_angle - params.search_angle_offset
    angles = angle_ramp(start_angle, A, params.search_angle_resolution)     # (..., A)

    # subsample points (front-packed valid points)
    sidx, svalid, divisor = _sample_indices(
        n_valid, params.use_point_size, params.max_samples, dev)
    sidx = torch.clamp(sidx, max=points.shape[0] - 1)
    pts = points[sidx] * inv_res                    # (S,2) map units, local frame
    c, s = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    rx = c * pts[:, 0] - s * pts[:, 1]              # (..., A, S)
    ry = s * pts[:, 0] + c * pts[:, 1]

    # candidate offsets in map cells (correlate_scan_matcher.h:546-548)
    space_step = params.search_space_resolution * inv_res
    half = (params.search_space_size * inv_res) * 0.5
    if center_m is None:
        start_x = center_pose_map[..., 0:1] - half
        start_y = center_pose_map[..., 1:2] - half
        steps = torch.arange(N, dtype=torch.float32, device=dev) * space_step
        xs = start_x + steps
        ys = start_y + steps
    else:
        xs, ys = candidate_offsets(center_m, inv_res, half, N, space_step).unbind(-2)
    return CandidateGrid(rx, ry, svalid, divisor, angles, xs, ys)


def _candidate_values(probs, rx, ry, svalid, xs, ys, default_prob: float):
    """(B,A,S,Nx,Ny): what each sample adds to each candidate's sum — the map
    value under the candidate cell, ``default_prob`` outside the map, exact 0
    for an invalid sample."""
    B, H, W = probs.shape
    # integer cells: truncation of (coord + candidate + 0.5) (:647-648)
    gx = torch.floor(rx[:, :, :, None] + xs[:, None, None, :] + 0.5).to(torch.int64)
    gy = torch.floor(ry[:, :, :, None] + ys[:, None, None, :] + 0.5).to(torch.int64)
    okx = (gx >= 0) & (gx < W)                                   # (B,A,S,Nx)
    oky = (gy >= 0) & (gy < H)                                   # (B,A,S,Ny)
    sv = svalid[:, None, :, None, None]
    ok = okx[..., :, None] & oky[..., None, :] & sv              # (B,A,S,Nx,Ny)
    base = (torch.arange(B, device=probs.device) * (H * W))[:, None, None, None, None]
    flat = gy[..., None, :] * W + gx[..., :, None] + base
    # index -1 would mean "last element" here, not "drop": mask explicitly
    flat = torch.where(ok, flat, 0)
    vals = probs.reshape(-1)[flat]
    oob = torch.where(sv, float(default_prob), 0.0).to(probs.dtype)
    return torch.where(ok, vals, oob)


def correlation_scores_plain(probs, rx, ry, svalid, xs, ys,
                             default_prob: float, divisor):
    """Plain PyTorch version of the correlation kernel, same arguments as
    ``ops.cuda.correlation.correlation_scores``: probs (B,H,W), rx/ry
    (B,A,S), svalid (B,S), xs/ys (B,N), divisor (B,). Returns (B,A,N,N)
    indexed [a, kx, ky]: mean map probability over sampled beam endpoints
    (GetResponse, correlate_scan_matcher.h:637-662); invalid samples add
    exact 0, out-of-map cells add ``default_prob``."""
    vals = _candidate_values(probs, rx, ry, svalid, xs, ys, default_prob)
    return torch.sum(vals, dim=2) / divisor[:, None, None, None]


def correlation_scores_sliced(probs, rx, ry, svalid, xs, ys,
                              default_prob: float, divisor, slice_len: int):
    """The plain version with the sums taken in the CUDA kernels' order: the
    sample axis cut into slices of ``slice_len``, each slice added in index
    order from 0, the slices' partial sums added in slice order from 0. Every
    add is one f32 add, so on the same inputs this gives the kernels' bits."""
    vals = _candidate_values(probs, rx, ry, svalid, xs, ys, default_prob)
    total = torch.zeros_like(vals[:, :, 0])
    for s0 in range(0, vals.shape[2], slice_len):
        part = torch.zeros_like(total)
        for s in range(s0, min(s0 + slice_len, vals.shape[2])):
            part = part + vals[:, :, s]
        total = total + part
    return total / divisor[:, None, None, None]


_divisors: dict[tuple, torch.Tensor] = {}


def _divisor_tensor(B: int, value: float, device) -> torch.Tensor:
    """The (B,) f32 tensor filled with ``value``, made once per (B, value,
    device) and kept: a tier match then launches no fill for one float.
    Nothing writes to it."""
    key = (B, value, device)
    t = _divisors.get(key)
    if t is None:
        if len(_divisors) >= 1024:      # values are point counts: bounded anyway
            _divisors.clear()
        t = _divisors[key] = torch.full((B,), value, dtype=torch.float32,
                                        device=device)
    return t


def _batched(fn, grid: CandidateGrid, probs, default_prob: float):
    """Flatten the leading batch dims to one ``B`` and call a
    ``correlation_scores``-shaped function."""
    lead = probs.shape[:-2]
    A, S = grid.rx.shape[-2:]
    N = grid.xs.shape[-1]
    B = math.prod(lead)
    dev = probs.device
    scores = fn(
        probs.reshape(B, *probs.shape[-2:]).contiguous(),
        grid.rx.expand(*lead, A, S).reshape(B, A, S).contiguous(),
        grid.ry.expand(*lead, A, S).reshape(B, A, S).contiguous(),
        grid.svalid.expand(B, S).contiguous(),
        grid.xs.expand(*lead, N).reshape(B, N).contiguous(),
        grid.ys.expand(*lead, N).reshape(B, N).contiguous(),
        float(default_prob),
        _divisor_tensor(B, grid.divisor, dev),
    )
    return scores.reshape(*lead, A, N, N)


def score_candidates(spec: ProbMapSpec, params: CorrelativeParams,
                     probs, offset, points, mask, n_valid: int,
                     center_pose_map, scores_fn=correlation_scores_plain,
                     pose_world=None):
    """Score every (angle, x, y) candidate — with the plain PyTorch version
    unless another ``correlation_scores``-shaped function is given.

    Returns (scores (...,A,Nx,Ny), angles (...,A), xs (...,Nx), ys (...,Ny))
    where xs/ys are candidate sensor positions in map cells. ``mask`` is
    unused (valid points are front-packed); it keeps the JAX function's
    signature. ``pose_world``: the world pose ``center_pose_map`` was
    mapped from, if it was (``candidate_grid``'s ``center_m``, with
    ``offset``)."""
    center_m = None if pose_world is None else pose_world[..., :2] + offset
    grid = candidate_grid(spec, params, points, n_valid, center_pose_map, center_m)
    scores = _batched(scores_fn, grid, probs, spec.default_prob)
    return scores, grid.angles, grid.xs, grid.ys


def penalize_scores(params: CorrelativeParams, spec: ProbMapSpec,
                    scores, angles, xs, ys, center_pose_map):
    """Center-distance/angle penalty (PenalizeResponse,
    correlate_scan_matcher.h:718-745). Zero scores are left unpenalized."""
    if not params.use_center_penalty:
        return scores
    dist_gain = (K_DISTANCE_PENALTY_GAIN_COARSE if params.tier == COARSE
                 else K_DISTANCE_PENALTY_GAIN_FINE)
    res = spec.resolution
    dx = (xs - center_pose_map[..., 0:1]) * res
    dy = (ys - center_pose_map[..., 1:2]) * res
    dist_sq = dx[..., :, None] ** 2 + dy[..., None, :] ** 2         # (...,Nx,Ny) m^2
    dist_pen = torch.clamp(
        1.0 - dist_gain * dist_sq / (params.search_space_size / 2.0), min=0.5
    )
    dth = (angles - center_pose_map[..., 2:3]) ** 2
    ang_pen = torch.clamp(1.0 - K_ANGULAR_PENALTY_GAIN * dth / 0.349, min=0.9)
    pen = ang_pen[..., :, None, None] * dist_pen[..., None, :, :]
    return torch.where(torch.abs(scores) > K_DOUBLE_TOLERANCE, scores * pen, scores)


def find_best_candidate(scores, angles, xs, ys):
    """Score-weighted average of near-tied top candidates (FindBestCandidate,
    correlate_scan_matcher.h:670-710). Equivalent mask form of the
    sorted-break loop: all candidates with score >= best - tol participate
    (tie-safe: no ordering of equal scores is involved)."""
    dims = (-3, -2, -1)
    best = torch.amax(scores, dim=dims)
    m = (scores >= best[..., None, None, None] - K_RESPONSE_FILTER_TOLERANCE).to(scores.dtype)
    w = m * scores
    # the four sums in the order and with the roundings of the JAX
    # package's compiled step (ops/xla_rounding.py)
    wsum, sx, sy, sc, ss = tie_sums(w, xs, ys, torch.cos(angles), torch.sin(angles))
    wsum = torch.clamp(wsum, min=K_DOUBLE_TOLERANCE)
    x, y, tc, ts = sx / wsum, sy / wsum, sc / wsum, ss / wsum
    theta = torch.atan2(ts, tc)
    return torch.stack([x, y, theta], dim=-1), best


def _top_candidates(scores, angles, xs, ys, select_mask, k: int):
    """Top-k candidates by score among those passing ``select_mask`` — the
    vectorized form of the reference's sorted-scan-first-20 loops. A stable
    descending sort keeps the lowest flat index among equal scores (score
    plateaus are common; ``torch.topk`` promises no order among ties)."""
    Nx, Ny = scores.shape[-2:]
    flat_scores = torch.where(select_mask, scores, -math.inf).flatten(-3)
    top_s, top_i = torch.sort(flat_scores, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[..., :k], top_i[..., :k]
    ai = top_i // (Nx * Ny)
    xi = (top_i // Ny) % Nx
    yi = top_i % Ny
    valid = torch.isfinite(top_s)
    lead = top_i.shape[:-1]
    pick = lambda v, i: torch.gather(v.expand(*lead, -1), -1, i)
    return top_s, pick(angles, ai), pick(xs, xi), pick(ys, yi), valid


def _cov_from_entries(xx, xy, yy, aa):
    """(...,3,3) covariance [[xx,xy,0],[xy,yy,0],[0,0,aa]]."""
    z = torch.zeros_like(xx)
    return torch.stack([
        torch.stack([xx, xy, z], dim=-1),
        torch.stack([xy, yy, z], dim=-1),
        torch.stack([z, z, aa], dim=-1),
    ], dim=-2)


def positional_covariance(params: CorrelativeParams, spec: ProbMapSpec,
                          scores, angles, xs, ys, best_pose_map, best_score,
                          cov_in):
    """ComputePositionalCovariance (correlate_scan_matcher.h:887-956)."""
    max_ang_var = 4.0 * params.search_angle_resolution ** 2
    res = spec.resolution

    # degenerate: best score ~ 0
    degen = best_score < K_DOUBLE_TOLERANCE

    score_bound = torch.clamp(best_score - 0.1, max=0.5)
    top_s, _, top_x, top_y, fin = _top_candidates(
        scores, angles, xs, ys, scores > score_bound[..., None, None, None],
        K_MAX_VARIANCE_USE_POINT_SIZE
    )
    w = torch.where(fin, top_s, 0.0)
    norm = torch.sum(w, dim=-1)
    dx = torch.where(fin, top_x - best_pose_map[..., 0:1], 0.0)
    dy = torch.where(fin, top_y - best_pose_map[..., 1:2], 0.0)
    acc_xx = torch.sum(dx * dx * w, dim=-1)
    acc_xy = torch.sum(dx * dy * w, dim=-1)
    acc_yy = torch.sum(dy * dy * w, dim=-1)

    min_var = 0.1 * (params.search_space_resolution / res) ** 2
    nrm = torch.clamp(norm, min=K_DOUBLE_TOLERANCE)
    var_xx = torch.clamp(acc_xx / nrm, min=min_var)
    var_xy = acc_xy / nrm
    var_yy = torch.clamp(acc_yy / nrm, min=min_var)

    bs = torch.clamp(best_score, min=K_DOUBLE_TOLERANCE)
    has_norm = norm > K_DOUBLE_TOLERANCE
    r2 = res * res
    c00 = torch.where(has_norm, var_xx * r2 / bs, 1.0)
    c01 = torch.where(has_norm, var_xy * r2 / bs, 0.0)
    c11 = torch.where(has_norm, var_yy * r2 / bs, 1.0)
    c22 = torch.where(has_norm, max_ang_var, 1.0).to(scores.dtype)

    # zero-variance fallback (:948-955)
    c00 = torch.where(torch.abs(c00) < K_DOUBLE_TOLERANCE, K_MAX_VARIANCE, c00)
    c11 = torch.where(torch.abs(c11) < K_DOUBLE_TOLERANCE, K_MAX_VARIANCE, c11)

    c00 = torch.where(degen, K_MAX_VARIANCE, c00)
    c01 = torch.where(degen, 0.0, c01)
    c11 = torch.where(degen, K_MAX_VARIANCE, c11)
    c22 = torch.where(degen, max_ang_var, c22)
    return _cov_from_entries(c00, c01, c11, c22)


def angular_covariance(params: CorrelativeParams, spec: ProbMapSpec,
                       scores, angles, xs, ys, best_pose_map, best_score,
                       cov_in):
    """ComputeAngularCovariance (correlate_scan_matcher.h:965-1019) — writes
    only cov[2,2] of the incoming covariance (returned as a new tensor)."""
    max_ang_var = 4.0 * params.search_angle_resolution ** 2
    linear_tol = params.search_space_resolution / spec.resolution

    score_bound = torch.clamp(best_score - 0.1, max=0.5)
    xm = torch.abs(xs - best_pose_map[..., 0:1]) <= linear_tol
    ym = torch.abs(ys - best_pose_map[..., 1:2]) <= linear_tol
    select = ((scores >= score_bound[..., None, None, None])
              & xm[..., None, :, None] & ym[..., None, None, :])
    top_s, top_a, _, _, fin = _top_candidates(
        scores, angles, xs, ys, select, K_MAX_VARIANCE_USE_POINT_SIZE
    )
    w = torch.where(fin, top_s, 0.0)
    norm = torch.sum(w, dim=-1)
    da = torch.where(fin, top_a - best_pose_map[..., 2:3], 0.0)
    acc = torch.sum(da * da * w, dim=-1)

    var_aa = torch.where(norm > K_DOUBLE_TOLERANCE,
                         acc / torch.clamp(norm, min=K_DOUBLE_TOLERANCE),
                         200.0 * max_ang_var)
    var_aa = torch.where(best_score < K_DOUBLE_TOLERANCE, max_ang_var, var_aa)
    cov = cov_in.expand(*var_aa.shape, 3, 3).clone()
    cov[..., 2, 2] = var_aa
    return cov


def correlative_scan_match(spec: ProbMapSpec, params: CorrelativeParams,
                           probs, offset, points, mask, n_valid: int,
                           pose_world, cov_in) -> MatchResult:
    """One full tier match (BasedCorrelationScanMatch::ScanMatch,
    correlate_scan_matcher.h:784-875): score grid → penalty → tie-averaged
    best pose → tier-specific covariance → threshold-gated pose update.
    Scores come through the kernel wrapper: the CUDA kernel on the card, the
    plain version for CPU tensors."""
    center = world_to_map_pose(offset, spec.inv_res, pose_world)
    # the kernel wrapper ROBORTS_CORR_KERNEL selects: its CUDA kernel on the
    # card, the plain version on the CPU
    from .cuda.correlation import scores_fn

    scores, angles, xs, ys = score_candidates(
        spec, params, probs, offset, points, mask, n_valid, center,
        scores_fn=scores_fn(), pose_world=pose_world)
    scores = penalize_scores(params, spec, scores, angles, xs, ys, center)
    best_pose_map, best_score = find_best_candidate(scores, angles, xs, ys)

    if params.tier == COARSE:
        cov = positional_covariance(params, spec, scores, angles, xs, ys,
                                    best_pose_map, best_score, cov_in)
        cov = angular_covariance(params, spec, scores, angles, xs, ys,
                                 best_pose_map, best_score, cov)
    elif params.tier == FINE:
        cov = positional_covariance(params, spec, scores, angles, xs, ys,
                                    best_pose_map, best_score, cov_in)
    else:  # SUPER
        cov = angular_covariance(params, spec, scores, angles, xs, ys,
                                 best_pose_map, best_score, cov_in)

    # empty-scan guard (correlate_scan_matcher.h:792-795): response 0, keep pose
    if int(n_valid) > 0:
        response = torch.clamp(best_score, max=1.0)
    else:
        response = torch.zeros_like(best_score)
    accept = response > params.response_threshold
    new_world = map_to_world_pose(offset, spec.inv_res, best_pose_map)
    pose_out = torch.where(accept[..., None], new_world, pose_world)
    return MatchResult(pose=pose_out, response=response, cov=cov,
                       best_map_pose=best_pose_map)
