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

The JAX package's ``lax.while_loop``s become fixed loops of their largest
iteration count (``max_iters`` LM iterations of ``cg_iters`` CG steps) that
carry their stopping flags on the device, as ``ops/gauss_newton.py`` does:
a step taken after the loop's test has failed is computed and discarded
(``torch.where``), so the result is the while loop's exit state bit for bit
and no value is read on the host inside the solve. The edge Jacobians are a
function of the poses alone and are computed once per LM iteration.

Every one of the ``max_iters`` × ``cg_iters`` masked steps is launched
eagerly; the steps JAX's loops would take are counted beside them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..plain import lower
from ..utils.geometry import normalize_angle



class PoseGraphData(NamedTuple):
    """Pose-graph tensors (the solver's entire input); may be padded, with
    ``node_mask`` / ``edge_mask`` disabling the padding."""

    poses: torch.Tensor       # (N, 3) initial node poses
    node_mask: torch.Tensor   # (N,) bool
    edge_ij: torch.Tensor     # (E, 2) int64 [source, target]
    edge_rel: torch.Tensor    # (E, 3) measured relative pose (source frame)
    edge_info: torch.Tensor   # (E, 3, 3) information matrices
    edge_mask: torch.Tensor   # (E,) bool


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


def _gauge_mask(data: PoseGraphData):
    """(N, 1) mask that zeroes the update of node 0 (gauge fix) and of
    padding nodes."""
    m = data.node_mask.to(data.poses.dtype)[:, None].clone()
    m[0] = 0.0
    return m


class _Linearization(NamedTuple):
    """What one LM iteration's products share: the edge Jacobians at its
    poses, the masked information matrices and the gauge mask."""

    ja: torch.Tensor      # (E, 3, 3) d r / d pose_a
    jb: torch.Tensor      # (E, 3, 3) d r / d pose_b
    info: torch.Tensor    # (E, 3, 3) information, zero on padding edges
    gauge: torch.Tensor   # (N, 1) from _gauge_mask


def _linearize(poses, data: PoseGraphData, gauge) -> _Linearization:
    ja, jb = edge_jacobians(poses, data)
    info = data.edge_info * data.edge_mask.to(poses.dtype)[:, None, None]
    return _Linearization(ja, jb, info, gauge)


def _segment_sum(like, data: PoseGraphData, ga, gb):
    out = torch.zeros_like(like)
    out.index_add_(0, data.edge_ij[:, 0], ga)
    out.index_add_(0, data.edge_ij[:, 1], gb)
    return out


def _hvp(lin: _Linearization, data: PoseGraphData, x):
    """Gauss-Newton Hessian-vector product, matrix-free:
    H x = Σ_e J_e^T I_e J_e x, accumulated by segment-sum over edges."""
    xa = x[data.edge_ij[:, 0]]
    xb = x[data.edge_ij[:, 1]]
    jx = (torch.einsum("eij,ej->ei", lin.ja, xa) + torch.einsum("eij,ej->ei", lin.jb, xb))
    ijx = torch.einsum("eij,ej->ei", lin.info, jx)
    ga = torch.einsum("eji,ej->ei", lin.ja, ijx)
    gb = torch.einsum("eji,ej->ei", lin.jb, ijx)
    return _segment_sum(x, data, ga, gb) * lin.gauge


def _gradient(lin: _Linearization, poses, data: PoseGraphData):
    r = edge_residuals(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None]
    ir = torch.einsum("eij,ej->ei", data.edge_info, r) * w
    ga = torch.einsum("eji,ej->ei", lin.ja, ir)
    gb = torch.einsum("eji,ej->ei", lin.jb, ir)
    return _segment_sum(poses, data, ga, gb) * lin.gauge


def _block_diag(lin: _Linearization, data: PoseGraphData, damping):
    """(N,3,3) block-diagonal of H (+ LM damping) for preconditioning."""
    ba = torch.einsum("eki,ekl,elj->eij", lin.ja, lin.info, lin.ja)
    bb = torch.einsum("eki,ekl,elj->eij", lin.jb, lin.info, lin.jb)
    n = lin.gauge.shape[0]
    blocks = lin.info.new_zeros((n, 3, 3))
    blocks = _segment_sum(blocks, data, ba, bb)
    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
    return blocks + (damping + 1e-6) * eye[None]


def _pcg(lin: _Linearization, data: PoseGraphData, b, damping, iters: int,
         tol: float):
    """Preconditioned CG on (H + λI) x = b with block-Jacobi preconditioner:
    ``iters`` steps, each taken only while JAX's loop test — the residual
    above ``tol`` of ``b`` — holds before it (``active``, on the device).
    Every vector here is node-sized and, under edge sharding, the same on
    every rank: the test reads reduced products only. The block inverse is
    ``inv_ex``: the LU inverse of ``inv`` without its synchronising error
    check (``jnp.linalg.inv`` never raises either). Returns ``x`` and the
    number of steps taken (() int32)."""
    blocks = _block_diag(lin, data, damping)
    pinv, _ = torch.linalg.inv_ex(blocks.float())     # no bfloat16 inverse: the control's blocks in float32
    pinv = pinv.to(blocks.dtype)

    def precond(v):
        return torch.einsum("nij,nj->ni", pinv, v) * lin.gauge

    def matvec(v):
        return _hvp(lin, data, v) + damping * (v * lin.gauge)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12)

    def going(r):
        return torch.sqrt(torch.sum(r * r)) > tol * bnorm

    active = going(r)
    steps = torch.zeros((), dtype=torch.int32, device=b.device)
    for i in range(iters):
        if i:
            active = active & going(r)
        steps = steps + active
        hp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * hp
        z = precond(r_new)
        rz_new = torch.sum(r_new * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = torch.where(active, z + beta * p, p)
        r = torch.where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
    return x, steps


class _LMState(NamedTuple):
    """The LM loop's carry, as JAX's ``while_loop`` state: all on the
    device."""

    poses: torch.Tensor   # (N, 3)
    lam: torch.Tensor     # () damping
    cost: torch.Tensor    # () cost at ``poses``
    it: torch.Tensor      # () int32 iterations taken
    done: torch.Tensor    # () bool converged
    cg: torch.Tensor      # () int32 CG steps taken in those iterations


def _lm_iteration(state: _LMState, data: PoseGraphData, gauge, cg_iters: int) -> _LMState:
    """One LM iteration with Ceres-style accept/reject and adaptive
    damping; it changes nothing once ``done`` (JAX's loop has ended)."""
    poses, lam, cost, it, done, cg = state
    lin = _linearize(poses, data, gauge)
    g = _gradient(lin, poses, data)
    step, steps = _pcg(lin, data, -g, lam, cg_iters, 1e-6)
    new_poses = poses + step
    new_poses = torch.cat(
        [new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
    new_cost = graph_cost(new_poses, data)
    active = ~done
    improved = new_cost < cost
    taken = active & improved
    gnorm = torch.sqrt(torch.sum(g * g))
    converged = improved & ((cost - new_cost) < 1e-7 * (cost + 1e-12))
    converged = converged | (gnorm < 1e-10)
    return _LMState(
        poses=torch.where(taken, new_poses, poses),
        lam=torch.where(active, torch.where(
            improved, torch.clamp(lam * 0.33, min=1e-8), lam * 10.0), lam),
        cost=torch.where(taken, new_cost, cost),
        it=it + active,
        done=done | converged,
        cg=cg + steps * active)


def _packed(s: _LMState) -> torch.Tensor:
    """[poses (3N) | cost | LM iterations | CG steps] as one f32 vector."""
    f32 = s.poses.dtype
    return torch.cat([s.poses.reshape(-1), s.cost.reshape(1), s.it.to(f32).reshape(1),
                      s.cg.to(f32).reshape(1)])


def _masked_solve(data: PoseGraphData, max_iters: int, cg_iters: int) -> _LMState:
    """The masked loop, launched eagerly: ``max_iters`` iterations."""
    poses = data.poses
    f32 = dict(dtype=poses.dtype, device=poses.device)
    i32 = dict(dtype=torch.int32, device=poses.device)
    state = _LMState(
        poses=poses, lam=torch.full((), 1e-4, **f32),
        cost=graph_cost(poses, data),
        it=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=poses.device),
        cg=torch.zeros((), **i32))
    gauge = _gauge_mask(data)
    for _ in range(max_iters):
        state = _lm_iteration(state, data, gauge, cg_iters)
    return state


def solve_packed(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100):
    """The unsharded solve as one f32 vector [poses (3N) | cost | LM
    iterations | CG steps], the engine's one host read, launched eagerly
    (the second value, the program that ran it, is always None)."""
    if lower():
        low = data._replace(**{k: getattr(data, k).to(torch.bfloat16)
                               for k in ("poses", "edge_rel", "edge_info")})
        return _packed(_masked_solve(low, max_iters, cg_iters)).to(torch.float32), None
    return _packed(_masked_solve(data, max_iters, cg_iters)), None
