"""Offline scan-log container + (de)serialization.

Own copy of the JAX package's ``io/scan_log.py`` (the ``.npz`` layout is the
same, so a log written by either package loads in the other). Replaces the reference's ROS topic/tf plumbing (roborts_slam_node.cpp:44-63)
with a file-based log: the engine consumes logs produced by the simulator
(io/simulate.py) or converted from rosbags. NPZ keeps zero extra deps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.scan import LaserModel


@dataclasses.dataclass
class ScanLog:
    """A recorded run: ranges per scan + odometry + (optional) ground truth."""

    ranges: np.ndarray         # (N, B) float32, <=0 or inf = no return
    odom: np.ndarray           # (N, 3) float64 odometry poses
    times: np.ndarray          # (N,) float64 seconds
    laser: LaserModel
    gt_poses: np.ndarray | None = None   # (N, 3) true poses (sim only)

    def __len__(self) -> int:
        return self.ranges.shape[0]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            ranges=self.ranges.astype(np.float32),
            odom=self.odom,
            times=self.times,
            gt_poses=self.gt_poses if self.gt_poses is not None else np.zeros((0, 3)),
            laser_params=self.laser.to_array(),
        )

    @staticmethod
    def load(path: str) -> "ScanLog":
        z = np.load(path)
        laser = LaserModel.from_array(z["laser_params"])
        gt = z["gt_poses"]
        return ScanLog(
            ranges=z["ranges"], odom=z["odom"], times=z["times"],
            laser=laser, gt_poses=gt if gt.size else None,
        )
