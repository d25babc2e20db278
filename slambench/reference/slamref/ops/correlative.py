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
``n_valid`` is a device scalar (or a host ``int``, made one on the device by
``valid_count``), as the JAX package traces it: the sampling step, the
samples' validity and the score divisor are computed on the device, so that
no value of it is fixed in a captured step and nothing is read to use it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose
from ..plain import lower
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

# while "on", every tier match appends what the check reads of it to "tiers":
# its penalized score grid, response and threshold, its best pose, how far it
# and the covariance move when the tier's centre is shifted by a few float32
# spacings (``_shifted``), and how near a flip the positional covariance's
# choice of candidates lay (``_positional_cut``)
TAP = {"on": False, "shift": True, "tiers": []}
SHIFT_ULPS = 4      # the centre's shift, in float32 spacings of each coordinate


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
    divisor: torch.Tensor   # () f32 score divisor (use_point_size or n_valid)
    angles: torch.Tensor    # (..., A)
    xs: torch.Tensor        # (..., N) candidate sensor x (map cells)
    ys: torch.Tensor        # (..., N)


def valid_count(n_valid, device) -> torch.Tensor:
    """``n_valid`` as a () int32 tensor on ``device``: a tensor is taken as
    it is; a host ``int`` is written by one fill (no copy from host memory,
    no synchronisation)."""
    if isinstance(n_valid, torch.Tensor):
        return n_valid
    return torch.full((), int(n_valid), dtype=torch.int32, device=device)


def sample_rule(n_valid, use: int, max_samples: int, device):
    """Reference point-subsampling rule (correlate_scan_matcher.h:560-566)
    on the device: step = P // (use-1) when P >= 2*use else 1; iterate
    i*step < P. Returns (idx (S,) int64 = i*step, valid (S,) bool, small ()
    bool: P < 2*use, n () int64: P)."""
    n = valid_count(n_valid, device).to(torch.int64)
    small = n < 2 * use
    step = torch.where(small, 1, torch.div(n, max(use - 1, 1), rounding_mode="floor"))
    idx = torch.arange(max_samples, dtype=torch.int64, device=device) * step
    return idx, idx < n, small, n


def _sample_indices(n_valid, use_point_size: int, max_samples: int, device):
    """The scan matcher's subsampling (``sample_rule``): the score divisor
    is use (or P when P < 2*use) even if the sample count differs; exact in
    f32 for any count up to 2^24. Returns (idx (S,) int64, valid (S,) bool,
    divisor () f32), all on the device."""
    use = use_point_size
    idx, valid, small, n = sample_rule(n_valid, use, max_samples, device)
    divisor = torch.clamp(torch.where(small, n, use), min=1).to(torch.float32)
    return idx, valid, divisor


def candidate_grid(spec: ProbMapSpec, params: CorrelativeParams,
                   points, n_valid, center_pose_map,
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
    if lower():
        vals = _candidate_values(probs.to(torch.bfloat16), rx, ry, svalid, xs, ys,
                                 default_prob)
        return (torch.sum(vals, dim=2) / divisor[:, None, None, None]).to(probs.dtype)
    vals = _candidate_values(probs, rx, ry, svalid, xs, ys, default_prob)
    return torch.sum(vals, dim=2) / divisor[:, None, None, None]


def _divisor_tensor(B: int, divisor) -> torch.Tensor:
    """The kernels' (B,) f32 divisor from the () device divisor: a view for
    B = 1, one copy otherwise."""
    return divisor.expand(B).contiguous()


def _batched(fn, grid: CandidateGrid, probs, default_prob: float):
    """Flatten the leading batch dims to one ``B`` and call a
    ``correlation_scores``-shaped function."""
    lead = probs.shape[:-2]
    A, S = grid.rx.shape[-2:]
    N = grid.xs.shape[-1]
    B = math.prod(lead)
    scores = fn(
        probs.reshape(B, *probs.shape[-2:]).contiguous(),
        grid.rx.expand(*lead, A, S).reshape(B, A, S).contiguous(),
        grid.ry.expand(*lead, A, S).reshape(B, A, S).contiguous(),
        grid.svalid.expand(B, S).contiguous(),
        grid.xs.expand(*lead, N).reshape(B, N).contiguous(),
        grid.ys.expand(*lead, N).reshape(B, N).contiguous(),
        float(default_prob),
        _divisor_tensor(B, grid.divisor),
    )
    return scores.reshape(*lead, A, N, N)


def score_candidates(spec: ProbMapSpec, params: CorrelativeParams,
                     probs, offset, points, mask, n_valid,
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
                           probs, offset, points, mask, n_valid,
                           pose_world, cov_in) -> MatchResult:
    """One full tier match (BasedCorrelationScanMatch::ScanMatch,
    correlate_scan_matcher.h:784-875): score grid → penalty → tie-averaged
    best pose → tier-specific covariance → threshold-gated pose update.
    Scores come through the kernel wrapper: the CUDA kernel on the card, the
    plain version for CPU tensors."""
    center = world_to_map_pose(offset, spec.inv_res, pose_world)
    n_valid = valid_count(n_valid, probs.device)
    # the kernel wrapper ROBORTS_CORR_KERNEL selects: its CUDA kernel on the
    # card, the plain version on the CPU
    from ..plain import scores_fn

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
    response = torch.where(n_valid > 0, torch.clamp(best_score, max=1.0), 0.0)
    if TAP["on"]:
        TAP["tiers"].append({"scores": scores, "response": response,
                             "threshold": params.response_threshold,
                             "tier": params.tier, "spec": spec, "params": params,
                             "angles": angles, "xs": xs, "ys": ys,
                             "best_pose_map": best_pose_map, "best_score": best_score,
                             **(_shifted(spec, params, probs, offset, points, mask, n_valid,
                                         pose_world, cov_in, best_pose_map, cov)
                                if TAP["shift"] else {}),
                             "cut_margin": (_positional_cut(spec, params, probs, offset, points,
                                                            n_valid, pose_world, center, scores,
                                                            best_score)
                                            if params.tier in (COARSE, FINE) and TAP["shift"]
                                            else math.inf)})
    accept = response > params.response_threshold
    new_world = map_to_world_pose(offset, spec.inv_res, best_pose_map)
    pose_out = torch.where(accept[..., None], new_world, pose_world)
    return MatchResult(pose=pose_out, response=response, cov=cov,
                       best_map_pose=best_pose_map)


def _spacing(t: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at each element of ``t`` (at least that at 1)."""
    a = t.detach().abs().double().clamp(min=1.0)
    return torch.pow(2.0, torch.floor(torch.log2(a)) - 23)


def _shifted(spec, params, probs, offset, points, mask, n_valid, pose_world, cov_in,
             best_pose_map, cov) -> dict:
    """How far the tier's best pose (map cells, the larger of x and y, and
    radians) and covariance (relative, its positional block) move when its
    input pose is shifted by ``SHIFT_ULPS`` float32 spacings of the
    centre's metres and of its angle, at the eight corners of that box. A
    shift that small moves a well-posed match by as much; a sample that lies
    on a cell edge under some candidate rounds into the other cell and can
    move it by a fraction of a cell (two sums of the same floats in another
    order part there)."""
    TAP["on"] = False
    try:
        centre = pose_world[..., :2].double() + offset.double()
        dxy = SHIFT_ULPS * _spacing(centre)
        dth = SHIFT_ULPS * _spacing(pose_world[..., 2:3])
        pose_cells = pose_rad = cov_rel = 0.0
        c0 = cov[..., :2, :2].double()
        scale = c0.abs().amax(dim=(-2, -1)).clamp(min=1e-12)
        for sx in (-1, 1):
            for sy in (-1, 1):
                for st in (-1, 1):
                    d = torch.cat([dxy[..., :1] * sx, dxy[..., 1:2] * sy, dth * st], -1)
                    res = correlative_scan_match(spec, params, probs, offset, points, mask,
                                                 n_valid, (pose_world.double() + d).float(),
                                                 cov_in)
                    gap = (res.best_map_pose.double() - best_pose_map.double()).abs()
                    pose_cells = max(pose_cells, float(gap[..., :2].max()))
                    pose_rad = max(pose_rad, float(gap[..., 2].max()))
                    rel = ((res.cov[..., :2, :2].double() - c0).abs().amax(dim=(-2, -1))
                           / scale)
                    cov_rel = max(cov_rel, float(rel.max()))
    finally:
        TAP["on"] = True
    return {"shift_pose_cells": pose_cells, "shift_pose_rad": pose_rad,
            "shift_cov_rel": cov_rel}


def _positional_cut(spec, params, probs, offset, points, n_valid, pose_world, center,
                    scores, best_score) -> float:
    """How near a flip of the last bits of the sums the positional
    covariance's choice of its ``K_MAX_VARIANCE_USE_POINT_SIZE`` candidates
    lay (those above ``best - 0.1``, at most 0.5, the best first; equal
    scores in flat order). Where more pass than it takes: the distance of
    the score at the cut from the nearest other score, 0 where equal scores
    straddle the cut and their sums could part (their per-sample values or
    their penalties differ; candidates whose values and penalties are equal
    are summed alike in any order that is the same for every candidate);
    where fewer pass, the least distance of a score from the bound."""
    k = K_MAX_VARIANCE_USE_POINT_SIZE
    n = scores.shape[-3] * scores.shape[-2] * scores.shape[-1]
    flat = scores.detach().reshape(-1, n)
    bound = torch.clamp(best_score.detach() - 0.1, max=0.5).reshape(-1, 1)
    sel = flat > bound
    margin = math.inf
    grid = None
    for b in range(flat.shape[0]):
        if int(sel[b].sum()) <= k:
            margin = min(margin, float((flat[b] - bound[b]).abs().min()))
            continue
        v = torch.where(sel[b], flat[b], -math.inf).sort(descending=True).values
        cut = v[k - 1]
        others = flat[b][flat[b] != cut]
        gap = float((others - cut).abs().min()) if others.numel() else math.inf
        if v[k] != cut:
            margin = min(margin, gap)
            continue
        if grid is None:
            center_m = pose_world[..., :2] + offset
            grid = candidate_grid(spec, params, points, n_valid, center, center_m)
            lead = probs.shape[:-2]
            B = math.prod(lead)
            A, S = grid.rx.shape[-2:]
            N = grid.xs.shape[-1]
            rx = grid.rx.expand(*lead, A, S).reshape(B, A, S)
            ry = grid.ry.expand(*lead, A, S).reshape(B, A, S)
            xs = grid.xs.expand(*lead, N).reshape(B, N)
            ys = grid.ys.expand(*lead, N).reshape(B, N)
            maps = probs.reshape(B, *probs.shape[-2:])
            pen = penalize_scores(params, spec, torch.ones_like(scores), grid.angles,
                                  grid.xs, grid.ys, center).reshape(-1, n)
        tied = torch.nonzero(flat[b] == cut).reshape(-1)
        vals = _candidate_values(maps[b:b + 1], rx[b:b + 1], ry[b:b + 1],
                                 grid.svalid.expand(1, -1), xs[b:b + 1], ys[b:b + 1],
                                 spec.default_prob)[0]            # (A, S, Nx, Ny)
        Nx, Ny = vals.shape[-2:]
        rows = vals[tied // (Nx * Ny), :, (tied // Ny) % Nx, tied % Ny]   # (T, S)
        p = pen[min(b, pen.shape[0] - 1)][tied]
        alike = bool((rows == rows[:1]).all()) and bool((p == p[:1]).all())
        margin = min(margin, gap if alike else 0.0)
    return margin
