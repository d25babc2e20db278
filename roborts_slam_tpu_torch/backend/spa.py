"""Sparse Pose Adjustment (SPA) solver in PyTorch.

Counterpart of the JAX package's ``backend/spa.py`` (the reference's Ceres
back-end, src/pose_graph/ceres_pose_graph_solver.{h,cpp} + ceres_types.h):
the ``PoseGraph2dErrorTerm`` residual (ceres_types.h:87-134)

    r_xy = R(yaw_a)^T (p_b − p_a) − p_ab,   r_th = wrap(yaw_b − yaw_a − yaw_ab)

weighted by the edge information matrix, minimized by Levenberg-Marquardt
with the first pose held constant for gauge. The normal equations are solved
matrix-free: H·x is evaluated edge-wise with segment sums (``index_add_``)
and never materialized, preconditioned by the block-Jacobi 3x3 diagonal.
This is plain tensor algebra (it was never a hand-written kernel).

The JAX package's ``lax.while_loop``s are Python loops here, with the same
iteration and stopping rules; each loop condition reads one scalar from the
device — a host synchronisation, counted in ``host_syncs``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.geometry import normalize_angle

host_syncs = 0     # device->host scalar reads made by loop conditions so far


class PoseGraphData(NamedTuple):
    """Pose-graph tensors (the solver's entire input); may be padded, with
    ``node_mask`` / ``edge_mask`` disabling the padding."""

    poses: torch.Tensor       # (N, 3) initial node poses
    node_mask: torch.Tensor   # (N,) bool
    edge_ij: torch.Tensor     # (E, 2) int64 [source, target]
    edge_rel: torch.Tensor    # (E, 3) measured relative pose (source frame)
    edge_info: torch.Tensor   # (E, 3, 3) information matrices
    edge_mask: torch.Tensor   # (E,) bool


def _read(flag) -> bool:
    """One scalar device->host read (a synchronisation on the card)."""
    global host_syncs
    host_syncs += 1
    return bool(flag)


def _endpoints(poses, data: PoseGraphData):
    pa = poses[data.edge_ij[:, 0]]
    pb = poses[data.edge_ij[:, 1]]
    c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    return pa, pb, c, s, dx, dy


def edge_residuals(poses, data: PoseGraphData):
    """(E, 3) residuals of every edge at the given poses."""
    pa, pb, c, s, dx, dy = _endpoints(poses, data)
    rx = c * dx + s * dy - data.edge_rel[:, 0]
    ry = -s * dx + c * dy - data.edge_rel[:, 1]
    rt = normalize_angle(pb[:, 2] - pa[:, 2] - data.edge_rel[:, 2])
    return torch.stack([rx, ry, rt], -1)


def edge_jacobians(poses, data: PoseGraphData):
    """Analytic Jacobians: (E,3,3) wrt node a and node b."""
    _, _, c, s, dx, dy = _endpoints(poses, data)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    # d r / d pose_a
    ja = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], -1),
        torch.stack([s, -c, -c * dx - s * dy], -1),
        torch.stack([zeros, zeros, -ones], -1),
    ], -2)
    # d r / d pose_b
    jb = torch.stack([
        torch.stack([c, s, zeros], -1),
        torch.stack([-s, c, zeros], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], -2)
    return ja, jb


def graph_cost(poses, data: PoseGraphData):
    r = edge_residuals(poses, data)
    w = data.edge_mask.to(poses.dtype)
    return 0.5 * torch.sum(w * torch.einsum("ei,eij,ej->e", r, data.edge_info, r))


def _gauge_project(x, node_mask):
    """Zero the update of node 0 (gauge fix) and of padding nodes."""
    m = node_mask.to(x.dtype)[:, None].clone()
    m[0] = 0.0
    return x * m


def _segment_sum(like, data: PoseGraphData, ga, gb):
    out = torch.zeros_like(like)
    out.index_add_(0, data.edge_ij[:, 0], ga)
    out.index_add_(0, data.edge_ij[:, 1], gb)
    return out


def _reduced(x, reduce_fn):
    return x if reduce_fn is None else reduce_fn(x)


def _hvp(poses, data: PoseGraphData, x, reduce_fn=None):
    """Gauss-Newton Hessian-vector product, matrix-free:
    H x = Σ_e J_e^T I_e J_e x, accumulated by segment-sum over edges (and
    over the edge shards by ``reduce_fn``)."""
    ja, jb = edge_jacobians(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None, None]
    xa = x[data.edge_ij[:, 0]]
    xb = x[data.edge_ij[:, 1]]
    jx = (torch.einsum("eij,ej->ei", ja, xa) + torch.einsum("eij,ej->ei", jb, xb))
    ijx = torch.einsum("eij,ej->ei", data.edge_info * w, jx)
    ga = torch.einsum("eji,ej->ei", ja, ijx)
    gb = torch.einsum("eji,ej->ei", jb, ijx)
    return _gauge_project(_reduced(_segment_sum(x, data, ga, gb), reduce_fn),
                          data.node_mask)


def _gradient(poses, data: PoseGraphData, reduce_fn=None):
    r = edge_residuals(poses, data)
    ja, jb = edge_jacobians(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None]
    ir = torch.einsum("eij,ej->ei", data.edge_info, r) * w
    ga = torch.einsum("eji,ej->ei", ja, ir)
    gb = torch.einsum("eji,ej->ei", jb, ir)
    return _gauge_project(_reduced(_segment_sum(poses, data, ga, gb), reduce_fn),
                          data.node_mask)


def _block_diag(poses, data: PoseGraphData, damping, reduce_fn=None):
    """(N,3,3) block-diagonal of H (+ LM damping) for preconditioning."""
    ja, jb = edge_jacobians(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None, None]
    info = data.edge_info * w
    ba = torch.einsum("eki,ekl,elj->eij", ja, info, ja)
    bb = torch.einsum("eki,ekl,elj->eij", jb, info, jb)
    blocks = torch.zeros((poses.shape[0], 3, 3), dtype=poses.dtype,
                         device=poses.device)
    blocks = _reduced(_segment_sum(blocks, data, ba, bb), reduce_fn)
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    return blocks + (damping + 1e-6) * eye[None]


def _pcg(poses, data: PoseGraphData, b, damping, iters: int, tol: float,
         reduce_fn=None):
    """Preconditioned CG on (H + λI) x = b with block-Jacobi preconditioner.
    One host read per iteration (the residual test). Every vector here is
    node-sized and, under edge sharding, the same on every rank: the tested
    residual comes from reduced products only."""
    pinv = torch.linalg.inv(_block_diag(poses, data, damping, reduce_fn))

    def precond(v):
        return _gauge_project(torch.einsum("nij,nj->ni", pinv, v), data.node_mask)

    def matvec(v):
        return _hvp(poses, data, v, reduce_fn) + damping * _gauge_project(v, data.node_mask)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12)

    i = 0
    while i < iters and _read(torch.sqrt(torch.sum(r * r)) > tol * bnorm):
        hp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
        i += 1
    return x


def lm_solve(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100,
             reduce_fn=None, scalar_reduce_fn=None):
    """Levenberg-Marquardt loop with Ceres-style accept/reject and adaptive
    damping. Returns (poses, final_cost, iterations). The accept/reject
    selections stay on the device (``torch.where``); one host read per outer
    iteration tests convergence. ``reduce_fn`` / ``scalar_reduce_fn`` sum the
    node-sized normal-equation pieces and the cost over edge shards
    (parallel/dist_spa.py); with both ``None`` nothing else changes."""
    poses = data.poses
    lam = torch.as_tensor(1e-4, dtype=poses.dtype, device=poses.device)

    def cost_fn(p):
        return _reduced(graph_cost(p, data), scalar_reduce_fn)

    cost = cost_fn(poses)
    it = 0
    done = False
    while it < max_iters and not done:
        g = _gradient(poses, data, reduce_fn)
        step = _pcg(poses, data, -g, lam, cg_iters, 1e-6, reduce_fn)
        new_poses = poses + step
        new_poses = torch.cat(
            [new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
        new_cost = cost_fn(new_poses)
        improved = new_cost < cost
        poses = torch.where(improved, new_poses, poses)
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-8), lam * 10.0)
        gnorm = torch.sqrt(torch.sum(g * g))
        converged = improved & ((cost - new_cost) < 1e-7 * (cost + 1e-12))
        converged = converged | (gnorm < 1e-10)
        cost = torch.where(improved, new_cost, cost)
        it += 1
        done = _read(converged)
    return poses, cost, it


def solve_pose_graph(data: PoseGraphData, max_iters: int = 50,
                     cg_iters: int = 100):
    """Single-device SPA solve (see lm_solve)."""
    return lm_solve(data, max_iters=max_iters, cg_iters=cg_iters)


def solve_pose_graph_dense(data: PoseGraphData, max_iters: int = 50):
    """Levenberg-Marquardt on the dense 3N x 3N normal equations
    (``torch.linalg.solve``): the validation path, and the fastest option for
    small graphs. Node 0 and the padding nodes are pinned by unit rows and
    columns. The accept/reject and stopping tests read the new cost on the
    host once per iteration (counted in ``host_syncs``), as the JAX package's
    Python loop does. Returns (poses, final_cost)."""
    global host_syncs
    n = data.poses.shape[0]
    dev, dt = data.poses.device, data.poses.dtype
    ia, ib = data.edge_ij[:, 0], data.edge_ij[:, 1]
    ar = torch.arange(3, device=dev)
    pin = ~data.node_mask
    pin[0] = True
    pin3 = pin.repeat_interleave(3)
    pinned = pin3[:, None] | pin3[None, :]

    def block(a, b):
        """(E, 3, 3) row and column indices of the (a, b) blocks of H."""
        return ((3 * a)[:, None, None] + ar[None, :, None],
                (3 * b)[:, None, None] + ar[None, None, :])

    def build_h_g(poses, lam: float):
        r = edge_residuals(poses, data)
        ja, jb = edge_jacobians(poses, data)
        w = data.edge_mask.to(dt)
        info = data.edge_info * w[:, None, None]
        haa = torch.einsum("eki,ekl,elj->eij", ja, info, ja)
        hab = torch.einsum("eki,ekl,elj->eij", ja, info, jb)
        hbb = torch.einsum("eki,ekl,elj->eij", jb, info, jb)
        hf = torch.zeros((3 * n, 3 * n), dtype=dt, device=dev)
        hf.index_put_(block(ia, ia), haa, accumulate=True)
        hf.index_put_(block(ia, ib), hab, accumulate=True)
        hf.index_put_(block(ib, ia), hab.transpose(-1, -2), accumulate=True)
        hf.index_put_(block(ib, ib), hbb, accumulate=True)
        ir = torch.einsum("eij,ej->ei", info, r)
        g = _segment_sum(poses, data, torch.einsum("eji,ej->ei", ja, ir),
                         torch.einsum("eji,ej->ei", jb, ir))
        hf = torch.where(pinned, 0.0, hf)
        diag = torch.where(pin3, torch.ones((), dtype=dt, device=dev),
                           torch.full((), lam + 1e-8, dtype=dt, device=dev))
        hf = hf + torch.diag(diag)
        gf = torch.where(pin3, 0.0, g.reshape(-1))
        return hf, gf

    poses = data.poses
    lam = 1e-4
    cost = graph_cost(poses, data)
    host_syncs += 1
    cost_f = float(cost)
    for _ in range(max_iters):
        hf, gf = build_h_g(poses, lam)
        step = torch.linalg.solve(hf, -gf).reshape(-1, 3)
        new_poses = poses + step
        new_poses = torch.cat(
            [new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
        new_cost = graph_cost(new_poses, data)
        host_syncs += 1
        new_f = float(new_cost)
        if new_f < cost_f:
            prev_f = cost_f
            poses, cost, cost_f = new_poses, new_cost, new_f
            lam = max(lam * 0.33, 1e-8)
            if (prev_f - cost_f) < 1e-9 * (prev_f + 1e-12):
                break
        else:
            lam *= 10.0
            if lam > 1e8:
                break
    return poses, cost
