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

On the card an unsharded solve runs the ``SolveProgram`` of its padded
shape (``PoseGraph.as_solver_data`` pads to JAX's buckets), the counterpart
of JAX's one jitted program per bucket: one LM iteration captured into a
CUDA graph at the first solve in a bucket and replayed by every later one.
Its preconditioned CG is one hand-written kernel (``ops/cuda/spa_pcg.cu``)
that stops on JAX's residual test, so only the CG steps JAX's loop takes
run; the LM iterations stay masked. A bucket past the kernel's one
cluster (8192 nodes, 16384 edges) is refused there. The masked ``_pcg`` is
the CG of the CPU, of the sharded solve and of ``lm_solve(replay=False)``.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

from ..ops.cuda import launch, spa_pcg
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


def _preconditioner(lin: _Linearization, data: PoseGraphData, damping, reduce_fn=None):
    """(N, 3, 3) inverses of the block-Jacobi diagonal: ``inv_ex``, the LU
    inverse of ``inv`` without its synchronising error check
    (``jnp.linalg.inv`` never raises either)."""
    return torch.linalg.inv_ex(_block_diag(lin, data, damping, reduce_fn))[0]


def _pcg(lin: _Linearization, data: PoseGraphData, b, damping, iters: int,
         tol: float, reduce_fn=None):
    """Preconditioned CG on (H + λI) x = b with block-Jacobi preconditioner:
    ``iters`` steps, each taken only while JAX's loop test — the residual
    above ``tol`` of ``b`` — holds before it (``active``, on the device).
    Every vector here is node-sized and, under edge sharding, the same on
    every rank: the test reads reduced products only. Returns ``x`` and the
    number of steps taken (() int32). The kernel ``spa_pcg`` runs the same
    steps and stops where the test fails (``SolveProgram``)."""
    pinv = _preconditioner(lin, data, damping, reduce_fn)

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


def _lm_iteration(state: _LMState, data: PoseGraphData, gauge, cg_iters: int,
                  reduce_fn, scalar_reduce_fn, pcg=None) -> _LMState:
    """One LM iteration with Ceres-style accept/reject and adaptive
    damping; it changes nothing once ``done`` (JAX's loop has ended).
    ``pcg(lin, b, lam, done)``, where given, solves for the step in place of
    the masked ``_pcg`` (the kernel: ``SolveProgram._kernel_pcg``)."""
    poses, lam, cost, it, done, cg = state
    lin = _linearize(poses, data, gauge)
    g = _gradient(lin, poses, data, reduce_fn)
    if pcg is None:
        step, steps = _pcg(lin, data, -g, lam, cg_iters, 1e-6, reduce_fn)
    else:
        step, steps = pcg(lin, -g, lam, done)
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
        done=done | converged,
        cg=cg + steps * active)


def closure_path(device) -> str:
    """How an unsharded SPA solve on ``device`` runs: "graph: cg kernel" (a
    program per bucket replayed from a CUDA graph, its CG the kernel) or
    "eager: cpu tensors" (a sharded solve is eager everywhere)."""
    return "graph: cg kernel" if torch.device(device).type == "cuda" else "eager: cpu tensors"


def _init_state(s: _LMState, data: PoseGraphData):
    """Reset the carry ``s`` in place to the start of a solve of ``data``."""
    s.poses.copy_(data.poses)
    s.lam.fill_(1e-4)
    s.cost.copy_(graph_cost(data.poses, data))
    s.it.zero_()
    s.done.zero_()
    s.cg.zero_()


def _packed(s: _LMState) -> torch.Tensor:
    """[poses (3N) | cost | LM iterations | CG steps] as one f32 vector."""
    f32 = s.poses.dtype
    return torch.cat([s.poses.reshape(-1), s.cost.reshape(1), s.it.to(f32).reshape(1),
                      s.cg.to(f32).reshape(1)])


def _unpacked(packed: torch.Tensor):
    """(poses (N, 3), cost, LM iterations (int32)) of a packed solve."""
    n = (packed.shape[0] - 3) // 3
    return packed[:3 * n].view(n, 3), packed[3 * n], packed[3 * n + 1].to(torch.int32)


class SolveProgram:
    """The unsharded solve at one padded shape on the card, the counterpart
    of JAX's ``solve_pose_graph`` compiled once per bucket: static graph
    and carry buffers and one LM iteration captured into a CUDA graph,
    reused by every solve at that shape.

    A solve copies the graph into the buffers, builds its incidence lists
    (``spa_pcg.incidence``, on the device), resets the carry and replays
    the iteration ``max_iters`` times; the first solve runs its first
    iteration eagerly (the warm-up a capture needs, and a real iteration)
    and captures the second on a side stream. The iteration is the masked
    ``_lm_iteration`` with its CG the kernel ``spa_pcg``; a shape past the
    kernel's one cluster is refused (``ValueError``). The kernel's launch
    count is added at every replay. The capture is
    thread-local (the engine's front end launches and reads from another
    thread meanwhile; a draw from the card's random generator there would
    be refused, and the engine makes none) and holds
    ``step_graph.capture_guard``. A capture that fails raises; nothing falls
    back to eager launches. ``last`` says what the latest solve did:
    "capture" or "replay", ``last_capture_s`` the seconds its capture took
    (the warm-up iteration included)."""

    def __init__(self, device, pn: int, pe: int, max_iters: int, cg_iters: int):
        if not spa_pcg.holds(pn, pe):
            raise ValueError(f"SolveProgram: {pn} nodes and {pe} edges exceed the CG "
                             f"kernel's one cluster ({spa_pcg.MAX_CLUSTER * spa_pcg.NODE_SPAN} "
                             f"nodes, {spa_pcg.MAX_CLUSTER * spa_pcg.EDGE_SPAN} edges)")
        f32 = dict(dtype=torch.float32, device=device)
        self.data = PoseGraphData(
            poses=torch.zeros((pn, 3), **f32),
            node_mask=torch.zeros((pn,), dtype=torch.bool, device=device),
            edge_ij=torch.zeros((pe, 2), dtype=torch.int64, device=device),
            edge_rel=torch.zeros((pe, 3), **f32), edge_info=torch.zeros((pe, 3, 3), **f32),
            edge_mask=torch.zeros((pe,), dtype=torch.bool, device=device))
        i32 = dict(dtype=torch.int32, device=device)
        self.state = _LMState(
            poses=torch.zeros((pn, 3), **f32), lam=torch.zeros((), **f32),
            cost=torch.zeros((), **f32), it=torch.zeros((), **i32),
            done=torch.zeros((), dtype=torch.bool, device=device),
            cg=torch.zeros((), **i32))
        self.gauge = torch.zeros((pn, 1), **f32)
        self.ptr = torch.zeros((pn + 1,), **i32)        # incidence lists
        self.entries = torch.zeros((2 * pe,), **i32)
        self.name = f"solve_{pn}x{pe}"
        self.max_iters, self.cg_iters = max_iters, cg_iters
        self.graph = None
        self.launches: list = []          # (counter, args) of the captured launches
        self.last = None
        self.last_capture_s = 0.0         # seconds the latest solve spent capturing
        self._lock = threading.Lock()
        self._done = None                 # event after the latest solve's output

    def _kernel_pcg(self, lin: _Linearization, b, lam, done):
        """The iteration's CG as one launch of the kernel (the blocks'
        inverses come column-major from the batched LU: made contiguous)."""
        pinv = _preconditioner(lin, self.data, lam).contiguous()
        return spa_pcg.pcg(lin.ja, lin.jb, lin.info, lin.gauge, pinv, b, lam, done,
                           self.data.edge_ij, self.ptr, self.entries, self.cg_iters, 1e-6)

    def _iteration(self):
        """One LM iteration on the static buffers, in place."""
        s = self.state
        for dst, src in zip(s, _lm_iteration(s, self.data, self.gauge, self.cg_iters,
                                             None, None, self._kernel_pcg)):
            dst.copy_(src)

    def _capture(self):
        dev = self.gauge.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        if side == main:                  # the caller's own stream from the pool
            side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        launches: list = []
        t = time.perf_counter()
        with torch.cuda.stream(side):
            self._iteration()             # the warm-up: a real iteration
            with capture_guard(), launch.capturing(launches, {}):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._iteration()
                finally:
                    graph.capture_end()
        main.wait_stream(side)
        self.last_capture_s = time.perf_counter() - t
        self.graph, self.launches = graph, launches

    def __call__(self, data: PoseGraphData) -> torch.Tensor:
        """Solve ``data`` (on the card, padded to this program's shape);
        returns a new packed vector (``_packed``)."""
        with self._lock:
            main = torch.cuda.current_stream(self.gauge.device)
            if self._done is not None:
                main.wait_event(self._done)
            for dst, src in zip(self.data, data):
                dst.copy_(src, non_blocking=True)
            self.gauge.copy_(_gauge_mask(self.data))
            for dst, src in zip((self.ptr, self.entries),
                                spa_pcg.incidence(self.data.edge_ij, self.ptr.shape[0] - 1)):
                dst.copy_(src)
            _init_state(self.state, self.data)
            n = self.max_iters
            self.last, self.last_capture_s = "replay", 0.0
            if self.graph is None:
                self._capture()
                self.last = "capture"
                n -= 1
            for _ in range(n):
                self.graph.replay()
                for counter, args in self.launches:
                    counter(*args)
            out = _packed(self.state)
            self._done = torch.cuda.Event()
            self._done.record(main)
            return out


_programs: dict = {}          # (device, shape, budgets, sum mode) -> SolveProgram
_programs_lock = threading.Lock()


def program_key(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100) -> tuple:
    """The key of ``data``'s solve program (``solve_program``)."""
    return (str(data.poses.device), data.poses.shape[0], data.edge_ij.shape[0], max_iters,
            cg_iters, torch.are_deterministic_algorithms_enabled())


def solve_program(data: PoseGraphData, max_iters: int = 50,
                  cg_iters: int = 100) -> SolveProgram:
    """The program of ``data``'s padded shape on its card, made at the first
    solve at that shape and kept for the process, as JAX keeps a compiled
    executable: keyed by the device, the node and edge buckets, the
    iteration budgets and whether deterministic sums are on (a capture holds
    the algorithms chosen while it was made)."""
    key = program_key(data, max_iters, cg_iters)
    with _programs_lock:
        prog = _programs.get(key)
        if prog is None:
            prog = _programs[key] = SolveProgram(data.poses.device, *key[1:5])
        return prog


def _masked_solve(data: PoseGraphData, max_iters: int, cg_iters: int,
                  reduce_fn=None, scalar_reduce_fn=None) -> _LMState:
    """The masked loop, launched eagerly: ``max_iters`` iterations."""
    poses = data.poses
    f32 = dict(dtype=poses.dtype, device=poses.device)
    i32 = dict(dtype=torch.int32, device=poses.device)
    state = _LMState(
        poses=poses, lam=torch.full((), 1e-4, **f32),
        cost=_reduced(graph_cost(poses, data), scalar_reduce_fn),
        it=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=poses.device),
        cg=torch.zeros((), **i32))
    gauge = _gauge_mask(data)
    for _ in range(max_iters):
        state = _lm_iteration(state, data, gauge, cg_iters, reduce_fn, scalar_reduce_fn)
    return state


def solve_packed(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100,
                 replay: bool = True):
    """The unsharded solve as one f32 vector [poses (3N) | cost | LM
    iterations | CG steps], the engine's one host read, and the program that
    ran it (None where it ran eagerly: CPU tensors, ``replay`` False, no
    iteration)."""
    if replay and data.poses.is_cuda and max_iters > 0:
        prog = solve_program(data, max_iters, cg_iters)
        return prog(data), prog
    return _packed(_masked_solve(data, max_iters, cg_iters)), None


def lm_solve(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100,
             reduce_fn=None, scalar_reduce_fn=None, replay: bool = True):
    """Levenberg-Marquardt loop with Ceres-style accept/reject and adaptive
    damping, JAX's ``while_loop``. Returns (poses, final_cost, iterations)
    as device tensors; nothing is read on the host. ``reduce_fn`` /
    ``scalar_reduce_fn`` sum the node-sized normal-equation pieces and the
    cost over edge shards (parallel/dist_spa.py); with both ``None`` nothing
    else changes. An unsharded solve on the card runs its shape's
    ``SolveProgram`` unless ``replay`` is False (the eager yardstick);
    every other solve launches the masked loop of ``max_iters`` iterations
    eagerly."""
    if reduce_fn is None and scalar_reduce_fn is None:
        return _unpacked(solve_packed(data, max_iters, cg_iters, replay)[0])
    s = _masked_solve(data, max_iters, cg_iters, reduce_fn, scalar_reduce_fn)
    return s.poses, s.cost, s.it


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
