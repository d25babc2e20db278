"""Padded pose graphs for the SPA kernel's tests, made with numpy from a seed
(no JAX, no torch): ``loop_graph`` and the graphs ``tests/data/
spa_kernel_jax.npz`` holds JAX's solves of (``FIXTURE_GRAPHS``; rewritten by
``scripts/torch_spa_kernel_fixture.py``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "spa_kernel_jax.npz"
# (node bucket, edge bucket, seed) of the stored graphs
FIXTURE_GRAPHS = ((128, 256, 2), (512, 1024, 5), (1024, 2048, 7), (2048, 4096, 9))
FIELDS = ("poses", "node_mask", "edge_ij", "edge_rel", "edge_info", "edge_mask")


def _relative(a, b):
    """(k, 3) poses of ``b`` in the frames of ``a``."""
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    th = b[:, 2] - a[:, 2]
    return np.stack([c * dx + s * dy, -s * dx + c * dy, np.arctan2(np.sin(th), np.cos(th))], -1)


def loop_graph(bn: int, pe: int, seed: int) -> dict:
    """A graph padded as ``PoseGraph.as_solver_data`` pads one: 3/4 of
    ``bn`` nodes round a circle of 5 m, the odometry chain and
    random loop edges up to 3/4 of ``pe`` edges (at least the chain), each measured between noisy
    copies of the ground truth with a random information matrix, the start
    the ground truth plus noise (node 0 exact); padding nodes masked at zero
    poses, padding edges masked at (0, 0) with zero measurements and
    identity information. Returns the six arrays by field name."""
    rng = np.random.default_rng(seed)
    n = 3 * bn // 4
    e = max(n - 1, 3 * pe // 4)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([5 * np.cos(t), 5 * np.sin(t),
                   np.arctan2(np.cos(t), -np.sin(t))], -1)
    # loop edges between any two nodes: on a circle of 5 m every node lies
    # within 10 m of every other, as on a robot's laps round one block
    a = rng.integers(0, n, e - (n - 1))
    b = (a + rng.integers(2, n - 1, a.shape)) % n
    ij = np.concatenate([np.stack([np.arange(n - 1), np.arange(1, n)], -1),
                         np.stack([np.minimum(a, b), np.maximum(a, b)], -1)])
    meas_a = gt[ij[:, 0]] + rng.normal(0, 0.01, (e, 3)) * [1, 1, 0.3]
    meas_b = gt[ij[:, 1]] + rng.normal(0, 0.01, (e, 3)) * [1, 1, 0.3]
    rel = _relative(meas_a, meas_b)
    ang = rng.uniform(0, np.pi, e)
    sd = rng.uniform(0.02, 0.05, (e, 2))
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    cov_xy = rot @ (sd[:, :, None] ** 2 * np.eye(2)) @ np.swapaxes(rot, -1, -2)
    info = np.zeros((e, 3, 3))
    info[:, :2, :2] = np.linalg.inv(cov_xy)
    info[:, 2, 2] = 1.0 / rng.uniform(0.005, 0.02, e) ** 2
    init = gt + rng.normal(0, 0.05, gt.shape) * [1, 1, 0.3]
    init[0] = gt[0]

    out = {"poses": np.zeros((bn, 3), np.float32), "node_mask": np.zeros(bn, bool),
           "edge_ij": np.zeros((pe, 2), np.int64), "edge_rel": np.zeros((pe, 3), np.float32),
           "edge_info": np.tile(np.eye(3, dtype=np.float32), (pe, 1, 1)),
           "edge_mask": np.zeros(pe, bool)}
    out["poses"][:n] = init
    out["node_mask"][:n] = True
    out["edge_ij"][:e] = ij
    out["edge_rel"][:e] = rel
    out["edge_info"][:e] = info
    out["edge_mask"][:e] = True
    return out
