"""Trajectory evaluation: ATE metrics for the benchmark scenes (NumPy).

Own copy of the JAX package's ``utils/evaluation.py``."""

from __future__ import annotations

import numpy as np


def align_trajectories(est_xy: np.ndarray, gt_xy: np.ndarray):
    """Umeyama (rigid, no scale) alignment est → gt; returns (R, t)."""
    mu_e = est_xy.mean(0)
    mu_g = gt_xy.mean(0)
    E = est_xy - mu_e
    G = gt_xy - mu_g
    H = E.T @ G
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    S = np.diag([1.0, d])
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over matched xy positions."""
    e = est[:, :2].astype(np.float64)
    g = gt[:, :2].astype(np.float64)
    assert e.shape == g.shape
    if align:
        R, t = align_trajectories(e, g)
        e = e @ R.T + t
    return float(np.sqrt(np.mean(np.sum((e - g) ** 2, axis=1))))


def match_by_time(est_tp: np.ndarray, gt_poses: np.ndarray,
                  gt_times: np.ndarray):
    """Pair estimated (t,x,y,th) rows with GT poses by nearest timestamp."""
    idx = np.searchsorted(gt_times, est_tp[:, 0])
    idx = np.clip(idx, 0, len(gt_times) - 1)
    return est_tp[:, 1:4], gt_poses[idx]
