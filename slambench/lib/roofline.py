"""Speed-of-light accounting for the kernels the benchmark reads: the
correlative tier match and the carve.

A copy of the program's ``bench/roofline.py`` (the tier's count) and of the
peak table of its ``utils/profiling.py``, kept here so that a change to the
program cannot move the yardstick. The counts are the algorithm's work on
the inputs, never what a kernel reads:

- a tier of ``B`` maps, ``A`` angles, ``S`` sample slots of which
  ``S_valid`` lie within the scan and ``N x N`` candidates:
  operations ``B * A * S_valid * (N^2 + 4N)``; bytes: each distinct map cell
  the candidates read, 4 bytes once, plus the rotated samples, the sample
  mask, the offsets, the divisor and the output scores once;
- a carve of one scan into an ``H x W`` count map: the mark image written
  once (``H * W * 4`` bytes) plus the sensor cell, the beams' end cells and
  their mask read once; one operation a ray cell, which never bounds it.
"""

from __future__ import annotations

import torch

# Published peaks, keyed by ``torch.cuda.get_device_name()``: NVIDIA's H100
# SXM data sheet, dense rates at the full 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_tflops": 67.0, "hbm_gbps": 3350.0,
                              "power_limit_w": 700.0},
}


def peaks(kind: str) -> dict:
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    return DEVICE_PEAKS[kind]


def bound_s(bytes_moved: float, operations: float, kind: str) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    p = peaks(kind)
    return max(bytes_moved / (p["hbm_gbps"] * 1e9), operations / (p["f32_tflops"] * 1e12))


def tier_cost(map_hw, rx, ry, svalid, xs, ys, batch: int = 1) -> tuple[float, float]:
    """(bytes, operations) of one tier over ``batch`` maps of shape
    ``map_hw`` (H, W) on one map's candidate grid: ``rx``/``ry`` (A, S)
    rotated samples, ``svalid`` (S,), ``xs``/``ys`` (N,) candidate offsets,
    in map cells. A sample reads the cell floor(sample + offset + 0.5);
    samples off the map or not valid read none. The maps of a batch are
    distinct, each read as the first."""
    A, S = rx.shape
    N = xs.shape[-1]
    H, W = map_hw
    gx = torch.floor(rx[:, :, None] + xs[None, None, :] + 0.5).long()
    gy = torch.floor(ry[:, :, None] + ys[None, None, :] + 0.5).long()
    ok = (((gx >= 0) & (gx < W))[..., :, None] & ((gy >= 0) & (gy < H))[..., None, :]
          & svalid[None, :, None, None])
    flat = gy[..., None, :] * W + gx[..., :, None]
    cells = int(torch.unique(flat[ok]).numel())
    valid = int(svalid.sum())
    B = batch
    nbytes = B * (cells * 4 + 2 * A * S * 4 + S + 2 * N * 4 + 4 + A * N * N * 4)
    return float(nbytes), float(B * A * valid * (N * N + 4 * N))


def match_cost(fine_spec, matcher, points, n_valid: int, pose, offset, map_hw,
               batch: int = 1) -> tuple[float, float]:
    """(bytes, operations) of one three-tier match (coarse, fine, super-fine,
    every tier on the fine map's grid) of the scan ``points`` / ``n_valid``
    at world ``pose`` on ``batch`` maps of shape ``map_hw`` whose corner is
    at ``offset``. Every tier is centred at ``pose``: a tier's centre is the
    previous tier's result, a few cells away."""
    from slamref.models.grid_map import world_to_map_pose
    from slamref.ops.correlative import candidate_grid

    center = world_to_map_pose(offset, fine_spec.inv_res, pose)
    total_b = total_o = 0.0
    for params in (matcher.coarse, matcher.fine, matcher.super_fine):
        g = candidate_grid(fine_spec, params, points, n_valid, center)
        b, o = tier_cost(map_hw, g.rx, g.ry, g.svalid, g.xs, g.ys, batch)
        total_b += b
        total_o += o
    return total_b, total_o


def carve_cost(map_hw, beams: int) -> tuple[float, float]:
    """(bytes, operations) of carving one scan of ``beams`` beam slots into
    a count map of shape ``map_hw``."""
    H, W = map_hw
    return float(H * W * 4 + beams * 9 + 8), float(beams)
