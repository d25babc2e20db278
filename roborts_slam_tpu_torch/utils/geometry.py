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


def rot2(theta):
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def pose_compose(a, b):
    """SE(2) composition a ⊕ b: apply b in a's frame. (...,3)x(...,3)->(...,3)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = normalize_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def pose_inverse(a):
    """SE(2) inverse: pose_compose(pose_inverse(a), a) == identity."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], dim=-1)


def pose_relative(a, b):
    """Relative pose of b expressed in a's frame: a⁻¹ ⊕ b (the reference's
    ``TransformByMidFrame(pose_1, pose_2).Transform(0)``,
    pose_graph.h:88-107)."""
    return pose_compose(pose_inverse(a), b)


def transform_points(pose, points):
    """Apply SE(2) pose to local points. pose (...,3), points (...,N,2)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    c, s = c[..., None], s[..., None]
    x = c * points[..., 0] - s * points[..., 1] + pose[..., None, 0]
    y = s * points[..., 0] + c * points[..., 1] + pose[..., None, 1]
    return torch.stack([x, y], dim=-1)


def points_bound_box(points, mask):
    """Masked axis-aligned bound box of a point set (reference
    ``BoundBox2d``, boundbox.h:34-147). Returns ((2,) min, (2,) max); an
    empty mask yields an inverted box like the reference's initial state."""
    big = 3.4e38
    w = mask[..., None]
    mn = torch.where(w, points, big).amin(dim=-2)
    mx = torch.where(w, points, -big).amax(dim=-2)
    return mn, mx


def bound_box_contains(mn, mx, xy):
    """Point-in-box test (BoundBox::Contain, boundbox.h:96-104)."""
    return torch.all((xy >= mn) & (xy <= mx), dim=-1)


def bound_box_union(mn1, mx1, mn2, mx2):
    """Box union (BoundBox::AddBoundBox, boundbox.h:77-94)."""
    return torch.minimum(mn1, mn2), torch.maximum(mx1, mx2)


def pose_change_enough(p1, p2, dist_thresh, angle_thresh):
    """Reference ``util::PoseChangeEnough`` (slam_util.h:113-126)."""
    d = p1[..., :2] - p2[..., :2]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    dth = torch.abs(normalize_angle(p1[..., 2] - p2[..., 2]))
    return (dist >= dist_thresh) | (dth >= angle_thresh)


def squared_distance(p1, p2):
    """xy squared distance between poses (slam_util.h:128-130)."""
    d = p1[..., :2] - p2[..., :2]
    return torch.sum(d * d, dim=-1)


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
