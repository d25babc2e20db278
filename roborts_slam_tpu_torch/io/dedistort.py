"""Odometry-based scan de-distortion (host-side NumPy).

Own copy of the JAX package's ``io/dedistort.py``, the replacement for
``LaserDataProcessor``
(src/laser_data_processor.{h,cpp}): the reference splits a sweep into ~5 ms
segments (kCorrectTimeResolution, laser_data_processor.h:40), interpolates
the lidar pose per segment from odometry tf (GetLaserPose :316), and
re-projects each beam into the frame-start pose (DataCorrect :154,
BeamsUpdate :231). Here the whole sweep is corrected in one vectorized pass:
per-beam pose interpolation + batched SE(2) re-projection.
"""

from __future__ import annotations

import numpy as np

from ..models.scan import LaserModel


def interpolate_poses(times: np.ndarray, odom_times: np.ndarray,
                      odom_poses: np.ndarray) -> np.ndarray:
    """Per-beam odometry pose by linear interpolation (angle via unwrap)."""
    x = np.interp(times, odom_times, odom_poses[:, 0])
    y = np.interp(times, odom_times, odom_poses[:, 1])
    th = np.interp(times, odom_times, np.unwrap(odom_poses[:, 2]))
    return np.stack([x, y, th], -1)


def dedistort_scan(ranges: np.ndarray, laser: LaserModel,
                   scan_start_time: float, sweep_duration: float,
                   odom_times: np.ndarray, odom_poses: np.ndarray,
                   reference: str = "start") -> np.ndarray:
    """Re-project every beam into one common lidar frame.

    ``reference`` selects the frame: "start" (sweep start, the reference's
    convention) or "end" (sweep end — use when the scan is timestamped, and
    odometry paired, at the END of the sweep; keeps corrected points
    consistent with the pose associated with the stamp). Returns (B, 2)
    points in that sensor frame; invalid beams (<= range_min or
    >= range_max) yield NaN.
    """
    B = laser.num_beams
    beam_times = scan_start_time + np.linspace(0.0, sweep_duration, B)
    poses = interpolate_poses(beam_times, odom_times, odom_poses)   # (B,3)
    p0 = poses[0] if reference == "start" else poses[-1]

    angles = laser.angles
    valid = (ranges > laser.range_min) & (ranges < laser.range_max)
    # beam endpoint in the world (odom) frame at each beam's own pose
    bx = ranges * np.cos(angles)
    by = ranges * np.sin(angles)
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    wx = poses[:, 0] + c * bx - s * by
    wy = poses[:, 1] + s * bx + c * by
    # back into the frame-start pose
    c0, s0 = np.cos(p0[2]), np.sin(p0[2])
    dx, dy = wx - p0[0], wy - p0[1]
    lx = c0 * dx + s0 * dy
    ly = -s0 * dx + c0 * dy
    pts = np.stack([lx, ly], -1)
    pts[~valid] = np.nan
    return pts
