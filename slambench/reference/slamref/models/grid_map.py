"""Occupancy grid map state.

Counterpart of the JAX package's ``models/grid_map.py`` (the reference's
``GridMapBase`` / ``OccuGridMap<Cell, Fn>`` hierarchy, src/map/*.h):

- Maps are fixed-shape tensors in small containers. The world extent is
  preallocated from the scene/laser range. Unlike the JAX package, whose
  maps are immutable and rely on buffer donation, the update ops in
  ``ops/raster.py`` write the map tensors **in place**.
- ``ProbMap``  ≈ ProbabilityCell map (ScanMatchMap, slam_map.h:34): one f32
  prob plane maintained by max-merge blur stamping only.
- ``CountMap`` ≈ CountCell map (PubMap, slam_map.h:35): hit/pass planes.
- The world↔map affine keeps the reference convention
  ``map_xy = (world_xy + offset) / resolution`` (grid_map_base.h:68-93).
- Spec shapes keep the JAX package's rounding to multiples of ``TILE``:
  map offsets derive from extents, so other shapes give other trajectories.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import gaussian_kernel_half_size

TILE = 128  # map dims are rounded up to multiples of this


def _round_up(x: int, m: int = TILE) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ProbMapSpec:
    """Static geometry + update rules of a probability (scan-match) map."""

    resolution: float
    height: int
    width: int
    deviation: float              # gaussian blur sigma (m)
    blur_offset: float            # cell_occu_prob_offset (gaussian_blur_offset)
    default_prob: float = 0.3     # kMapUnknownCellProb (slam_processor.h:264)
    # max cells any gated beam endpoint can lie from the search pose
    # (≈ (range_max + margin) / resolution); kept for spec parity with the
    # JAX package, unused by the CUDA matcher (it reads the whole map)
    coverage_cells: int = 0

    @property
    def inv_res(self) -> float:
        return 1.0 / self.resolution

    @property
    def kernel_half(self) -> int:
        return gaussian_kernel_half_size(self.deviation, self.resolution)

    def blur_kernel(self) -> np.ndarray:
        """Stamp kernel. Center value is 1.0 (SetCellOccuBlur sets the center
        cell prob to 1.0 when just_update_occu, occu_grid_map.h:544);
        neighbors get ``exp(-0.5 (d/sigma)^2) * blur_offset`` max-merged
        (occu_grid_map.h:560-573, kernel values occu_grid_map.h:88-94)."""
        h = self.kernel_half
        k = np.zeros((2 * h + 1, 2 * h + 1), dtype=np.float32)
        for j in range(-h, h + 1):
            for i in range(-h, h + 1):
                d = np.hypot(i * self.resolution, j * self.resolution)
                k[j + h, i + h] = np.exp(-0.5 * (d / max(self.deviation, 1e-9)) ** 2)
        k = k * self.blur_offset
        k[h, h] = 1.0
        return k


@dataclasses.dataclass(frozen=True)
class CountMapSpec:
    """Static geometry of a hit/pass count (publish) map."""

    resolution: float
    height: int
    width: int
    max_ray_cells: int            # static bound on cells per carved ray
    default_prob: float = 0.5     # kDefaultCellProb (grid_map_cell.h:30)
    # carve window side of the JAX package's carve kernel; kept for spec
    # parity, unused here (the CUDA carve kernel writes the whole map)
    carve_window: int = 0

    @property
    def inv_res(self) -> float:
        return 1.0 / self.resolution


class ProbMap(NamedTuple):
    probs: torch.Tensor      # (..., H, W) f32, indexed [y, x]
    offset: torch.Tensor     # (..., 2) f32 world offset (m)


class CountMap(NamedTuple):
    hits: torch.Tensor       # (H, W) f32
    passes: torch.Tensor     # (H, W) f32
    offset: torch.Tensor     # (2,) f32


def make_prob_map(spec: ProbMapSpec, offset, device) -> ProbMap:
    return ProbMap(
        probs=torch.full((spec.height, spec.width), spec.default_prob,
                         dtype=torch.float32, device=device),
        offset=torch.as_tensor(offset, dtype=torch.float32, device=device),
    )


def make_count_map(spec: CountMapSpec, offset, device) -> CountMap:
    return CountMap(
        hits=torch.zeros((spec.height, spec.width), dtype=torch.float32,
                         device=device),
        passes=torch.zeros((spec.height, spec.width), dtype=torch.float32,
                           device=device),
        offset=torch.as_tensor(offset, dtype=torch.float32, device=device),
    )


def world_to_map_pose(offset, inv_res: float, pose):
    """Pose variant keeping theta unchanged (grid_map_base.h:89-93)."""
    xy = (pose[..., :2] + offset) * inv_res
    return torch.cat([xy, pose[..., 2:3]], dim=-1)


def map_to_world_pose(offset, inv_res: float, pose):
    """Pose variant of ``map_to_world``, rounded as the JAX package's
    compiled step rounds it: one fused multiply-add by the f32 reciprocal
    of ``inv_res`` (``ops/xla_rounding.py``)."""
    from ..ops.xla_rounding import map_to_world_xy

    xy = map_to_world_xy(offset, inv_res, pose[..., :2])
    return torch.cat([xy, pose[..., 2:3]], dim=-1)


def pub_map_spec(config, laser_range_max: float, world_size: float) -> CountMapSpec:
    n = _round_up(int(np.ceil(world_size / config.map_resolution)))
    # rays are at most range_threshold long; Chebyshev cell count bound
    max_cells = int(np.ceil(laser_range_max / config.map_resolution)) + 4
    window = min(n, _round_up(2 * max_cells + 24))
    return CountMapSpec(
        resolution=config.map_resolution, height=n, width=n,
        max_ray_cells=max_cells, carve_window=window,
    )


def _prob_spec(config, resolution: float, deviation: float, n: int,
               coverage_m: float | None) -> ProbMapSpec:
    return ProbMapSpec(
        resolution=resolution, height=n, width=n, deviation=deviation,
        blur_offset=config.gaussian_blur_offset,
        coverage_cells=(int(np.ceil(coverage_m / resolution))
                        if coverage_m is not None else 0),
    )


def scan_match_map_specs(config, world_size: float,
                         coverage_m: float | None = None):
    """Front-end coarse + fine scan-match map specs (CreateAllMap,
    slam_processor.cpp:482-510)."""
    if config.match_map_window > 0:
        world_size = min(world_size, config.match_map_window)
    nc = _round_up(int(np.ceil(world_size / config.coarse_map_resolution)))
    nf = _round_up(int(np.ceil(world_size / config.fine_map_resolution)))
    coarse = _prob_spec(config, config.coarse_map_resolution,
                        config.coarse_map_deviation, nc, coverage_m)
    fine = _prob_spec(config, config.fine_map_resolution,
                      config.fine_map_deviation, nf, coverage_m)
    return coarse, fine


def backend_map_specs(config, laser_range_max: float):
    """Back-end chain-match map specs; sized ``(range_max + 2m) * 2`` per
    CreateScanMatchMapWithRangeVec (slam_processor.cpp:433-439,
    kMinScanMatchMapBound=2.0 slam_processor.h:263)."""
    size = (laser_range_max + 2.0) * 2.0
    coverage_m = laser_range_max + 2.0
    nc = _round_up(int(np.ceil(size / config.coarse_map_resolution)))
    nf = _round_up(int(np.ceil(size / config.fine_map_resolution)))
    coarse = _prob_spec(config, config.coarse_map_resolution,
                        config.coarse_map_deviation, nc, coverage_m)
    fine = _prob_spec(config, config.fine_map_resolution,
                      config.fine_map_deviation, nf, coverage_m)
    return coarse, fine
