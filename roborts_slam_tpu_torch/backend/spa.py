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
function of the poses alone and are computed once per LM iteration. On the
card an unsharded solve runs its first LM iteration eagerly on a side
stream, captures the next one in a CUDA graph and replays it for the rest:
the host issues one replay per LM iteration instead of every operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..step_graph import capture_guard
from ..utils.geometry import normalize_angle

host_syncs = 0     # device->host scalar reads made by the dense solve so far


class PoseGraphData(NamedTuple):
    """Pose-graph tensors (the solver's entire input); may be padded, with
    ``node_mask`` / ``edge_mask`` disabling the padding."""

    poses: torch.Tensor       # (N, 3) initial node poses
    node_mask: torch.Tensor   # (N,) bool
    edge_ij: torch.Tensor     # (E, 2) int64 [source, target]
    edge_rel: torch.Tensor    # (E, 3) measured relative pose (source frame)
    edge_info: torch.Tensor   # (E, 3, 3) information matrices
    edge_mask: torch.Tensor   # (E,) bool


def _read(x) -> float:
    """One scalar device->host read (a synchronisation on the card), counted
    in ``host_syncs``: the dense solve's accept/reject tests. ``lm_solve``
    makes none."""
    global host_syncs
    host_syncs += 1
    return float(x)


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


def _reduced(x, reduce_fn):
    return x if reduce_fn is None else reduce_fn(x)


def _hvp(lin: _Linearization, data: PoseGraphData, x, reduce_fn=None):
    """Gauss-Newton Hessian-vector product, matrix-free:
    H x = Σ_e J_e^T I_e J_e x, accumulated by segment-sum over edges (and
    over the edge shards by ``reduce_fn``)."""
    xa = x[data.edge_ij[:, 0]]
    xb = x[data.edge_ij[:, 1]]
    jx = (torch.einsum("eij,ej->ei", lin.ja, xa) + torch.einsum("eij,ej->ei", lin.jb, xb))
    ijx = torch.einsum("eij,ej->ei", lin.info, jx)
    ga = torch.einsum("eji,ej->ei", lin.ja, ijx)
    gb = torch.einsum("eji,ej->ei", lin.jb, ijx)
    return _reduced(_segment_sum(x, data, ga, gb), reduce_fn) * lin.gauge


def _gradient(lin: _Linearization, poses, data: PoseGraphData, reduce_fn=None):
    r = edge_residuals(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None]
    ir = torch.einsum("eij,ej->ei", data.edge_info, r) * w
    ga = torch.einsum("eji,ej->ei", lin.ja, ir)
    gb = torch.einsum("eji,ej->ei", lin.jb, ir)
    return _reduced(_segment_sum(poses, data, ga, gb), reduce_fn) * lin.gauge


def _block_diag(lin: _Linearization, data: PoseGraphData, damping, reduce_fn=None):
    """(N,3,3) block-diagonal of H (+ LM damping) for preconditioning."""
    ba = torch.einsum("eki,ekl,elj->eij", lin.ja, lin.info, lin.ja)
    bb = torch.einsum("eki,ekl,elj->eij", lin.jb, lin.info, lin.jb)
    n = lin.gauge.shape[0]
    blocks = lin.info.new_zeros((n, 3, 3))
    blocks = _reduced(_segment_sum(blocks, data, ba, bb), reduce_fn)
    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
    return blocks + (damping + 1e-6) * eye[None]


def _pcg(lin: _Linearization, data: PoseGraphData, b, damping, iters: int,
         tol: float, reduce_fn=None):
    """Preconditioned CG on (H + λI) x = b with block-Jacobi preconditioner:
    ``iters`` steps, each taken only while JAX's loop test — the residual
    above ``tol`` of ``b`` — holds before it (``active``, on the device).
    Every vector here is node-sized and, under edge sharding, the same on
    every rank: the test reads reduced products only. The block inverse is
    ``inv_ex``: the LU inverse of ``inv`` without its synchronising error
    check (``jnp.linalg.inv`` never raises either)."""
    pinv, _ = torch.linalg.inv_ex(_block_diag(lin, data, damping, reduce_fn))

    def precond(v):
        return torch.einsum("nij,nj->ni", pinv, v) * lin.gauge

    def matvec(v):
        return _hvp(lin, data, v, reduce_fn) + damping * (v * lin.gauge)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12)

    def going(r):
        return torch.sqrt(torch.sum(r * r)) > tol * bnorm

    active = going(r)
    for i in range(iters):
        if i:
            active = active & going(r)
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
    return x


class _LMState(NamedTuple):
    """The LM loop's carry, as JAX's ``while_loop`` state: all on the
    device."""

    poses: torch.Tensor   # (N, 3)
    lam: torch.Tensor     # () damping
    cost: torch.Tensor    # () cost at ``poses``
    it: torch.Tensor      # () int32 iterations taken
    done: torch.Tensor    # () bool converged


def _lm_iteration(state: _LMState, data: PoseGraphData, gauge, cg_iters: int,
                  reduce_fn, scalar_reduce_fn) -> _LMState:
    """One LM iteration with Ceres-style accept/reject and adaptive
    damping; it changes nothing once ``done`` (JAX's loop has ended)."""
    poses, lam, cost, it, done = state
    lin = _linearize(poses, data, gauge)
    g = _gradient(lin, poses, data, reduce_fn)
    step = _pcg(lin, data, -g, lam, cg_iters, 1e-6, reduce_fn)
    new_poses = poses + step
    new_poses = torch.cat(
        [new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
    new_cost = _reduced(graph_cost(new_poses, data), scalar_reduce_fn)
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
        done=done | converged)


def _replayed(step, state: _LMState, n: int) -> _LMState:
    """``n`` applications of ``step`` on the card: the first eagerly on a
    side stream (the warm-up that a capture needs, and a real iteration),
    the second captured there in a CUDA graph that writes its result back
    into its input, replayed ``n - 1`` times on the caller's stream. The
    capture is thread-local: the engine's front end launches and reads from
    another thread meanwhile (a draw from the card's random generator there
    would be refused; the engine makes none). The capture holds
    ``step_graph.capture_guard`` (no other capture, no graph destroyed and
    no garbage collected meanwhile). A capture that fails raises; nothing
    falls back to eager launches."""
    dev = state.poses.device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    if side == main:                  # the caller's own stream from the pool
        side = torch.cuda.Stream(dev)
    static = _LMState(*(torch.empty_like(t) for t in state))
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        for s, t in zip(static, step(state)):
            s.copy_(t)
        if n > 1:
            with capture_guard():
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    for s, t in zip(static, step(static)):
                        s.copy_(t)
                finally:
                    graph.capture_end()
    main.wait_stream(side)
    for _ in range(n - 1):
        graph.replay()
    return static


def lm_solve(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100,
             reduce_fn=None, scalar_reduce_fn=None, replay: bool = True):
    """Levenberg-Marquardt loop with Ceres-style accept/reject and adaptive
    damping, JAX's ``while_loop`` as a fixed loop of ``max_iters`` masked
    iterations. Returns (poses, final_cost, iterations) as device tensors;
    nothing is read on the host. ``reduce_fn`` / ``scalar_reduce_fn`` sum
    the node-sized normal-equation pieces and the cost over edge shards
    (parallel/dist_spa.py); with both ``None`` nothing else changes. An
    unsharded solve on the card replays its iterations from a CUDA graph
    (``_replayed``) unless ``replay`` is False (the eager yardstick); every
    other solve launches them eagerly."""
    poses = data.poses
    f32 = dict(dtype=poses.dtype, device=poses.device)
    state = _LMState(
        poses=poses, lam=torch.full((), 1e-4, **f32),
        cost=_reduced(graph_cost(poses, data), scalar_reduce_fn),
        it=torch.zeros((), dtype=torch.int32, device=poses.device),
        done=torch.zeros((), dtype=torch.bool, device=poses.device))
    gauge = _gauge_mask(data)

    def step(s):
        return _lm_iteration(s, data, gauge, cg_iters, reduce_fn, scalar_reduce_fn)

    if (replay and poses.is_cuda and max_iters > 0 and reduce_fn is None
            and scalar_reduce_fn is None):
        state = _replayed(step, state, max_iters)
    else:
        for _ in range(max_iters):
            state = step(state)
    return state.poses, state.cost, state.it


def solve_pose_graph(data: PoseGraphData, max_iters: int = 50,
                     cg_iters: int = 100):
    """Single-device SPA solve (see lm_solve)."""
    return lm_solve(data, max_iters=max_iters, cg_iters=cg_iters)


def solve_pose_graph_dense(data: PoseGraphData, max_iters: int = 50):
    """Levenberg-Marquardt on the dense 3N x 3N normal equations
    (``torch.linalg.solve``): the validation path, and the fastest option for
    small graphs. Node 0 and the padding nodes are pinned by unit rows and
    columns. The accept/reject and stopping tests read the new cost on the
    host once per iteration (``_read``), as the JAX package's Python loop
    does. Returns (poses, final_cost)."""
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
    cost_f = _read(cost)
    for _ in range(max_iters):
        hf, gf = build_h_g(poses, lam)
        step = torch.linalg.solve(hf, -gf).reshape(-1, 3)
        new_poses = poses + step
        new_poses = torch.cat(
            [new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
        new_cost = graph_cost(new_poses, data)
        new_f = _read(new_cost)
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
