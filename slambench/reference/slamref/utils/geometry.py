"""Vectorized SE(2) pose algebra on torch tensors.

Counterpart of the JAX package's ``utils/geometry.py``: plain functions on
``(..., 3)`` pose tensors ``[x, y, theta]``, batch-polymorphic over leading
dimensions. Results live on the device and dtype of their inputs.
"""

from __future__ import annotations

import math

import torch


def normalize_angle(angle):
    """Normalize to [-pi, pi] (reference ``util::NormalizeAngle``,
    slam_util.h:103-111)."""
    two_pi = 2.0 * math.pi
    a = torch.remainder(torch.remainder(angle, two_pi) + two_pi, two_pi)
    return torch.where(a > math.pi, a - two_pi, a)


def transform_points(pose, points):
    """Apply SE(2) pose to local points. pose (...,3), points (...,N,2)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    c, s = c[..., None], s[..., None]
    x = c * points[..., 0] - s * points[..., 1] + pose[..., None, 0]
    y = s * points[..., 0] + c * points[..., 1] + pose[..., None, 1]
    return torch.stack([x, y], dim=-1)


def pose_change_enough(p1, p2, dist_thresh, angle_thresh):
    """Reference ``util::PoseChangeEnough`` (slam_util.h:113-126)."""
    d = p1[..., :2] - p2[..., :2]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    dth = torch.abs(normalize_angle(p1[..., 2] - p2[..., 2]))
    return (dist >= dist_thresh) | (dth >= angle_thresh)


def predict_pose_by_odom(last_pose, last_odom, cur_odom):
    """Odometry-based pose prediction, exactly the reference formula
    (slam_processor.cpp:618-634): rebase the odom delta into the map frame
    via the yaw offset between the last corrected pose and last odom pose."""
    dth = last_pose[..., 2] - last_odom[..., 2]
    c, s = torch.cos(dth), torch.sin(dth)
    tx = last_pose[..., 0] - (c * last_odom[..., 0] - s * last_odom[..., 1])
    ty = last_pose[..., 1] - (s * last_odom[..., 0] + c * last_odom[..., 1])
    x = c * cur_odom[..., 0] - s * cur_odom[..., 1] + tx
    y = s * cur_odom[..., 0] + c * cur_odom[..., 1] + ty
    th = dth + cur_odom[..., 2]
    return torch.stack([x, y, th], dim=-1)
