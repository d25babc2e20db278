"""Speed-of-light accounting for the 3-tier correlative match.

The counterpart of the JAX package's ``bench/roofline.py``, counting the
algorithm's work rather than one implementation's layout, so that the same
count holds whichever kernel (or the plain version) computes a tier. Per
tier of ``B`` maps, ``A`` angles, ``S`` sample slots of which ``S_valid``
lie within the scan, and ``N × N`` candidate offsets:

- operations: ``B · A · S_valid · (N² + 4N)`` — one add per (candidate,
  sample) and the index arithmetic of a sample's row and column of cells;
- bytes: each distinct map cell the candidates read, 4 bytes once, plus the
  inputs (rotated samples, sample mask, offsets, divisor) and the output
  scores once. The distinct cells come from the candidate grid's indices,
  plain index arithmetic on the run's inputs.

The JAX count's slab build, 128-lane windows and deinterleave passes
(``roborts_slam_tpu/ops/pallas/correlation.py:74-204``) are steps of the
Pallas layout; none exists on the card, so none is counted here.

``bound`` turns bytes and operations into the least time the card could
take, from the published peaks of ``utils/profiling.DEVICE_PEAKS``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.profiling import device_peaks


@dataclasses.dataclass(frozen=True)
class TierCost:
    name: str
    batch: int
    n_angles: int
    n_space: int
    samples: int          # sample slots per angle (S)
    valid_samples: int    # of them within the scan's valid points, per map
    cells: int            # distinct map cells the tier's candidates read
    operations: float     # B · A · S_valid · (N² + 4N)
    hbm_bytes: float      # cells · 4 + the inputs and the output once


@dataclasses.dataclass(frozen=True)
class MatchCost:
    tiers: tuple
    total_operations: float
    total_hbm_bytes: float

    def as_dict(self) -> dict:
        return {
            "total_operations": self.total_operations,
            "total_hbm_bytes": self.total_hbm_bytes,
            "tiers": [dataclasses.asdict(t) for t in self.tiers],
        }


def tier_cost(name: str, map_shape, rx, ry, svalid, xs, ys) -> TierCost:
    """The work of one tier on the arguments of a ``correlation_scores``
    call: ``rx``/``ry`` (B,A,S) rotated samples, ``svalid`` (B,S), ``xs``/``ys``
    (B,N) candidate offsets, all in map cells, on maps of ``map_shape``
    (B,H,W). A sample reads the cell floor(sample + offset + 0.5); samples
    off the map or not valid read none."""
    B, A, S = rx.shape
    N = xs.shape[-1]
    _, H, W = map_shape
    gx = torch.floor(rx[:, :, :, None] + xs[:, None, None, :] + 0.5).long()
    gy = torch.floor(ry[:, :, :, None] + ys[:, None, None, :] + 0.5).long()
    ok = (((gx >= 0) & (gx < W))[..., :, None]
          & ((gy >= 0) & (gy < H))[..., None, :]
          & svalid[:, None, :, None, None])
    flat = (gy[..., None, :] * W + gx[..., :, None]
            + (torch.arange(B, device=rx.device) * H * W)[:, None, None, None, None])
    cells = int(torch.unique(flat[ok]).numel())
    valid = int(svalid.sum())                 # over the batch: B · S_valid
    hbm_bytes = (cells * 4 + 2 * B * A * S * 4 + B * S + 2 * B * N * 4 + B * 4
                 + B * A * N * N * 4)
    return TierCost(name=name, batch=B, n_angles=A, n_space=N, samples=S,
                    valid_samples=valid // B, cells=cells,
                    operations=float(A * valid * (N * N + 4 * N)),
                    hbm_bytes=float(hbm_bytes))


def scan_match_cost(matcher, fine_spec, points, n_valid: int, pose, offset,
                    batch: int = 1) -> MatchCost:
    """The work of one ``frontend/matchers.scan_match`` call (coarse, fine
    and super-fine tiers on the fine map) for ``batch`` maps of
    ``fine_spec``'s shape, with the scan ``points`` / ``n_valid`` at world
    ``pose`` on maps at ``offset``. Every tier is centred at ``pose``: a
    tier's centre is the previous tier's result, a few cells away, which
    moves the count of distinct cells only where the scan meets the map's
    edge."""
    from ..models.grid_map import world_to_map_pose
    from ..ops.correlative import candidate_grid

    center = world_to_map_pose(offset, fine_spec.inv_res, pose)
    shape = (batch, fine_spec.height, fine_spec.width)
    tiers = []
    for name, params in (("coarse", matcher.coarse), ("fine", matcher.fine),
                         ("super_fine", matcher.super_fine)):
        g = candidate_grid(fine_spec, params, points, n_valid, center)
        A, S = g.rx.shape[-2:]
        N = g.xs.shape[-1]
        tiers.append(tier_cost(
            name, shape, g.rx.expand(batch, A, S), g.ry.expand(batch, A, S),
            g.svalid.expand(batch, S), g.xs.expand(batch, N), g.ys.expand(batch, N)))
    return MatchCost(tiers=tuple(tiers),
                     total_operations=sum(t.operations for t in tiers),
                     total_hbm_bytes=sum(t.hbm_bytes for t in tiers))


def bound(bytes_moved: float, operations: float, device_kind: str | None = None):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the float32 rate, from the published peaks of
    ``device_kind`` (``None``: the current CUDA device). Returns (ms, which:
    ``"bytes"`` or ``"operations"``)."""
    _, peaks = device_peaks(device_kind)
    tb = bytes_moved / (peaks["hbm_gbps"] * 1e9) * 1e3
    to = operations / (peaks["f32_tflops"] * 1e12) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def roofline_summary(cost: MatchCost, seconds: float,
                     device_kind: str | None = None) -> dict:
    """Achieved rates of one measured match time against the published
    peaks of ``device_kind`` (``None``: the current CUDA device).
    ``hbm_frac`` and ``ops_frac`` are the shares of the memory rate and of
    the float32 rate the match reached; ``bound_us`` the least time of the
    match at those peaks."""
    _, peaks = device_peaks(device_kind)
    hbm_peak_gbps = peaks["hbm_gbps"]
    f32_peak_ops_per_s = peaks["f32_tflops"] * 1e12
    gbps = cost.total_hbm_bytes / seconds / 1e9
    ops = cost.total_operations / seconds
    bound_ms, bound_by = bound(cost.total_hbm_bytes, cost.total_operations, device_kind)
    return {
        "match_us": 1e6 * seconds,
        "hbm_bytes": cost.total_hbm_bytes,
        "achieved_gbps": gbps,
        "hbm_peak_gbps": hbm_peak_gbps,
        "hbm_frac": gbps / hbm_peak_gbps,
        "operations": cost.total_operations,
        "achieved_gops": ops / 1e9,
        "f32_peak_gops": f32_peak_ops_per_s / 1e9,
        "ops_frac": ops / f32_peak_ops_per_s,
        "bound_us": 1e3 * bound_ms,
        "bound_by": bound_by,
    }
