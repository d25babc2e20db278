"""Scan and sensor models (host-side NumPy ingest).

Own copy of the JAX package's ``models/scan.py`` ingest path: replaces the
reference's ``RangeDataContainer2d`` / ``LaserRangeFinder``
(src/slam/sensor_data_manager.h:32-346). Scans are fixed-shape, masked,
front-packed point arrays in the sensor-local frame (``max_points``
padding); they are packed on the host with NumPy and uploaded once by the
engine. Per-map scaling by ``1/resolution`` happens inside the ops.
``Scan`` / ``scan_from_ranges`` hold one scan as tensors on a device, for
callers outside the engine.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LaserModel:
    """Sensor intrinsics (reference ``LaserRangeFinder``,
    sensor_data_manager.h:32-78)."""

    angle_min: float
    angle_max: float
    range_min: float
    range_max: float
    num_beams: int
    range_threshold_scale: float = 0.95
    scan_time: float = 0.0     # sweep duration (s); 0 = instantaneous

    @property
    def range_threshold(self) -> float:
        """``range_min + scale * (range_max - range_min)``
        (sensor_data_manager.h:43-49); beams beyond it are dropped
        (roborts_slam_node.cpp:295-307)."""
        return self.range_min + self.range_threshold_scale * (
            self.range_max - self.range_min
        )

    @property
    def angles(self) -> np.ndarray:
        return np.linspace(self.angle_min, self.angle_max, self.num_beams)

    def to_array(self) -> np.ndarray:
        """Flat serialization used by .npz logs."""
        return np.array([self.angle_min, self.angle_max, self.range_min,
                         self.range_max, self.num_beams,
                         self.range_threshold_scale, self.scan_time])

    @staticmethod
    def from_array(a: np.ndarray) -> "LaserModel":
        return LaserModel(
            angle_min=float(a[0]), angle_max=float(a[1]),
            range_min=float(a[2]), range_max=float(a[3]),
            num_beams=int(a[4]), range_threshold_scale=float(a[5]),
            # older serializations predate the scan_time field
            scan_time=float(a[6]) if len(a) > 6 else 0.0,
        )


class Scan(NamedTuple):
    """One laser scan with a fixed-shape masked point set.

    points: (P, 2) float32 — cartesian points in the sensor-local frame (m).
    mask:   (P,) bool — valid-point mask (padding is False).
    pose:   (3,) float32 — sensor pose in world (estimated by SLAM).
    odom:   (3,) float32 — odometry pose at capture time.
    time:   () float32 — timestamp (s).
    """

    points: torch.Tensor
    mask: torch.Tensor
    pose: torch.Tensor
    odom: torch.Tensor
    time: torch.Tensor

    @property
    def num_valid(self):
        return torch.sum(self.mask.to(torch.int32))


def pack_points(pts: np.ndarray, max_points: int):
    """Front-pack a (N, 2) valid-point array into fixed-shape
    (points (max_points, 2), mask (max_points,), n)."""
    n = pts.shape[0]
    if n > max_points:
        raise ValueError(f"scan has {n} valid points > max_points={max_points}")
    points = np.zeros((max_points, 2), dtype=np.float32)
    points[:n] = pts
    mask = np.zeros((max_points,), dtype=bool)
    mask[:n] = True
    return points, mask, n


def ranges_to_packed(ranges: np.ndarray, laser: LaserModel,
                     max_points: int):
    """Polar → cartesian + range gating + front-packing
    (BuildRangeDataContainer, roborts_slam_node.cpp:290-311): keep beams with
    ``range_min < r < range_threshold``. Returns NumPy
    ``(points (max_points, 2) f32, mask (max_points,) bool, n_valid)``;
    valid points are front-packed so the subsampled-scoring stride rule sees
    the reference's point ordering."""
    ranges = np.asarray(ranges, dtype=np.float32)
    angles = laser.angles.astype(np.float32)
    valid = (ranges > laser.range_min) & (ranges < laser.range_threshold)
    r = ranges[valid]
    a = angles[valid]
    pts = np.stack([r * np.cos(a), r * np.sin(a)], axis=-1)
    return pack_points(pts, max_points)

