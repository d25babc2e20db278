"""Branch-and-bound correlative matcher — beam search over max-pooled score
bounds.

Counterpart of the JAX package's ``ops/branch_and_bound.py``
(``BranchAndBoundCorrelateScanMatcher``,
src/scan_match/correlate_scan_matcher.h:271-502). The search structure is
the JAX module's:

- **Admissible bounds**: level ``d`` scores against a max-pooled map
  ``M_d[y,x] = max_{k,l<2^d} M[y+k·st, x+l·st]``, so a parent's score
  upper-bounds every descendant. The pyramid is built by shift-max doubling.
- **Beam search**: at every depth the top ``beam_width`` candidates survive
  and all of their 2x2 children are scored in one batched gather. The search
  is exact whenever fewer than ``beam_width`` candidates bound above the
  true best at every depth.

Plain torch, no kernel of its own (the JAX module computes it outside any
Pallas kernel too). Differences: ``jnp.take(mode="fill")`` on index -1
becomes an explicit mask (index -1 would mean "last element" here);
``lax.top_k`` becomes a stable descending sort, which keeps the lowest index
among equal scores as ``top_k`` does. One map per call: a caller with a
batch of maps loops over it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose
from .correlative import _sample_indices


@dataclasses.dataclass(frozen=True)
class BnBParams:
    """FAST_CORRELATION_SCAN_MATCH parameter block; defaults are the
    reference's hard-coded test values (scan_matchers.h:337-344)."""

    search_space_size: float = 0.8
    search_space_resolution: float = 0.01
    search_angle_offset: float = 0.523
    search_angle_resolution: float = 0.00349
    response_threshold: float = 0.5
    use_point_size: int = 100
    max_depth: int = 4
    beam_width: int = 256            # the beam replaces DFS pruning

    @property
    def n_angles(self) -> int:
        return int(math.floor(self.search_angle_offset * 2
                              / self.search_angle_resolution) + 1)

    @property
    def max_samples(self) -> int:
        return 2 * self.use_point_size


class BnBResult(NamedTuple):
    pose: torch.Tensor      # (3,) world pose (updated iff score > threshold)
    response: torch.Tensor  # () best score
    best_map_pose: torch.Tensor  # (3,) best candidate in map coords


def max_pool_pyramid(probs, max_depth: int, step_cells: int,
                     default_prob: float):
    """levels[d][y, x] = max over {k·st, l·st : k,l < 2^d} of probs shifted —
    the admissible score bound for a candidate block of side ``2^d`` lattice
    steps anchored at (y, x). Built by shift-max doubling; shifted-out
    regions read the out-of-map default (GetGridProbValue semantics)."""
    def shift(m, dy, dx):
        h, w = m.shape
        out = torch.full_like(m, default_prob)
        out[: h - dy, : w - dx] = m[dy:, dx:]
        return out

    levels = [probs]
    m = probs
    for d in range(max_depth):
        s = step_cells * (1 << d)
        m = torch.maximum(m, shift(m, 0, s))
        m = torch.maximum(m, shift(m, s, 0))
        levels.append(m)
    return levels


def _score_at(spec: ProbMapSpec, level_probs, rx, ry, svalid, divisor: float,
              cand_x, cand_y, cand_ai):
    """Score candidates at arbitrary map positions (ScoreCandidates,
    correlate_scan_matcher.h:398-431) against one pyramid level."""
    crx = rx[cand_ai]                           # (C,S)
    cry = ry[cand_ai]
    gx = torch.floor(crx + cand_x[:, None] + 0.5).to(torch.int64)
    gy = torch.floor(cry + cand_y[:, None] + 0.5).to(torch.int64)
    ok = ((gx >= 0) & (gx < spec.width) & (gy >= 0) & (gy < spec.height)
          & svalid[None, :])
    flat = torch.where(ok, gy * spec.width + gx, 0)
    vals = level_probs.reshape(-1)[flat]
    oob = torch.where(svalid, float(spec.default_prob), 0.0).to(vals.dtype)
    vals = torch.where(ok, vals, oob[None, :])
    return torch.sum(vals, dim=1) / divisor      # (C,)


def _top_k(scores, k: int):
    """The k best scores and their indices, lowest index first among equals."""
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    return top_s[:k], top_i[:k]


def bnb_scan_match(spec: ProbMapSpec, params: BnBParams, probs, offset,
                   points, mask, n_valid: int, pose_world) -> BnBResult:
    """One branch-and-bound match (ScanMatch,
    correlate_scan_matcher.h:274-332) of one scan against one map
    ``probs (H,W)``. Requires an integer candidate step in map cells (true
    for the reference's parameter block on a 0.01 m map)."""
    del mask  # points are front-packed; n_valid drives sampling
    inv_res = spec.inv_res
    dev = probs.device
    f32 = dict(dtype=torch.float32, device=dev)
    st = params.search_space_resolution * inv_res
    st_i = int(round(st))
    if abs(st - st_i) >= 1e-6 or st_i < 1:
        raise ValueError(
            f"branch-and-bound requires an integer candidate step in map "
            f"cells, got {st}")
    center = world_to_map_pose(offset, inv_res, pose_world)

    A = params.n_angles
    D = params.max_depth
    n0 = int(round(params.search_space_size
                   / ((1 << D) * params.search_space_resolution)) + 1)

    angles = (center[2] - params.search_angle_offset
              + torch.arange(A, **f32) * params.search_angle_resolution)
    sidx, svalid, divisor = _sample_indices(n_valid, params.use_point_size,
                                            params.max_samples, dev)
    sidx = torch.clamp(sidx, max=points.shape[0] - 1)
    pts = points[sidx] * inv_res
    c, s = torch.cos(angles), torch.sin(angles)
    rx = c[:, None] * pts[None, :, 0] - s[:, None] * pts[None, :, 1]  # (A,S)
    ry = s[:, None] * pts[None, :, 0] + c[:, None] * pts[None, :, 1]

    start_x = center[0] - (params.search_space_size * inv_res) * 0.5
    start_y = center[1] - (params.search_space_size * inv_res) * 0.5

    levels = max_pool_pyramid(probs, D, st_i, spec.default_prob)

    # ---- level D: dense over (A, n0, n0) against the pooled bound ----
    stride0 = (1 << D) * st
    xs0 = start_x + torch.arange(n0, **f32) * stride0
    ys0 = start_y + torch.arange(n0, **f32) * stride0
    ai0 = torch.repeat_interleave(torch.arange(A, device=dev), n0 * n0)
    cx0 = torch.repeat_interleave(xs0, n0).repeat(A)
    cy0 = ys0.repeat(n0).repeat(A)
    sc0 = _score_at(spec, levels[D], rx, ry, svalid, divisor, cx0, cy0, ai0)

    K = min(params.beam_width, sc0.shape[0])
    beam_sc, idx = _top_k(sc0, K)
    beam_x, beam_y, beam_ai = cx0[idx], cy0[idx], ai0[idx]

    # ---- refine: depth d -> d-1, children at {0, half_width} offsets
    # (BranchAndBound :452-465), scored against level d-1 bounds ----
    for d in range(D, 0, -1):
        half = (1 << (d - 1)) * st
        offs = torch.tensor([[0.0, 0.0], [half, 0.0], [0.0, half], [half, half]],
                            **f32)
        cx = (beam_x[:, None] + offs[None, :, 0]).reshape(-1)   # (4K,)
        cy = (beam_y[:, None] + offs[None, :, 1]).reshape(-1)
        cai = torch.repeat_interleave(beam_ai, 4)
        sc = _score_at(spec, levels[d - 1], rx, ry, svalid, divisor,
                       cx, cy, cai)
        beam_sc, idx = _top_k(sc, min(K, sc.shape[0]))
        beam_x, beam_y, beam_ai = cx[idx], cy[idx], cai[idx]

    best_score = beam_sc[0]
    best_map = torch.stack([beam_x[0], beam_y[0], angles[beam_ai[0]]])

    # accept iff score > threshold (:322-326); else keep the input pose
    accept = best_score > params.response_threshold
    best_world = map_to_world_pose(offset, inv_res, best_map)
    pose = torch.where(accept, best_world, pose_world)
    return BnBResult(pose=pose, response=best_score, best_map_pose=best_map)
