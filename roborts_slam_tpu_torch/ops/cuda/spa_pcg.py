"""Wrapper of the SPA solve's preconditioned CG kernel (``spa_pcg.cu``).

``pcg`` runs the conjugate gradient of one Levenberg-Marquardt iteration —
(H + λ·gauge) x = b, block-Jacobi preconditioned, at most ``iters`` steps
each taken while ‖r‖ > tol·max(‖b‖, 1e-12) — in one launch on the card.
There is no fallback and no CPU version: it launches the kernel or raises.
The masked ``backend/spa.py::_pcg`` is the plain version its tests on the
card hold it against.

The kernel sums H·p node by node over each node's incident edges, in the
order of the node's incidence list (``incidence``), so it needs no atomics
and repeats bit for bit. The lists, the launch geometry (``geometry``: the
cluster, threads, and the nodes and edges each thread owns, from the padded
shape alone) and the lists' sums in the kernel's order
(``incidence_segment_sum``) are stated here, for the CPU tests.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch

from . import build, launch

pcg_launches = 0      # kernel launches so far, and by (nodes, edges):
pcg_shapes: collections.Counter = collections.Counter()
# both are counted by ``_count``, under ``launch.count_lock``

MAX_THREADS = 512     # kMaxThreads of spa_pcg.cu
NODE_SPAN = 1024      # most nodes a CTA owns: two a thread
EDGE_SPAN = 2048      # most edges a CTA owns: four a thread
MAX_CLUSTER = 8       # CTAs of the largest (portable) cluster
EDGES_PER_THREAD = (1, 2, 4)    # the kernel's instantiations (EPT); NPT is 1 or 2
SLOT_FLOATS = 3 * 16  # the reductions' slots: three of kMaxWarps floats

_fns: dict[str, object] = {}
_plans: dict[tuple, "_Plan"] = {}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch spreads a graph of ``nodes`` nodes and ``edges`` edges:
    one cluster of ``cluster`` CTAs of ``threads`` threads; CTA r owns nodes
    [r·node_span, (r+1)·node_span) and edges [r·edge_span, (r+1)·edge_span),
    thread t of it the local nodes t, t + threads (``npt`` of them) and
    edges t, t + threads, ... (``ept``); ``smem_bytes`` of shared memory a
    CTA: p, x and the preconditioner blocks of its nodes, the two sides'
    products of its edges, the reductions' slots."""

    nodes: int
    edges: int
    cluster: int
    threads: int
    node_span: int
    edge_span: int
    npt: int
    ept: int
    smem_bytes: int


def geometry(nodes: int, edges: int) -> Geometry | None:
    """The launch geometry of a graph of this padded shape: the smallest
    cluster whose CTAs hold at most ``NODE_SPAN`` nodes and ``EDGE_SPAN``
    edges each, and as many threads (a multiple of 32, at most
    ``MAX_THREADS``) as the larger span needs at one item a thread. None
    where no cluster of up to ``MAX_CLUSTER`` CTAs holds it (past 8192
    nodes or 16384 edges)."""
    if nodes < 1 or edges < 1:
        raise ValueError(f"spa_pcg: a graph of {nodes} nodes and {edges} edges")
    cluster = 1
    while nodes > cluster * NODE_SPAN or edges > cluster * EDGE_SPAN:
        cluster *= 2
    if cluster > MAX_CLUSTER:
        return None
    node_span, edge_span = -(-nodes // cluster), -(-edges // cluster)
    threads = min(MAX_THREADS, 32 * -(-max(node_span, edge_span) // 32))
    npt = -(-node_span // threads)
    ept = 1 << (-(-edge_span // threads) - 1).bit_length()
    smem = 4 * (15 * node_span + 6 * edge_span + SLOT_FLOATS)
    return Geometry(nodes, edges, cluster, threads, node_span, edge_span, npt, ept, smem)


def holds(nodes: int, edges: int) -> bool:
    """Whether one launch of the kernel holds a graph of this padded shape."""
    return geometry(nodes, edges) is not None


def incidence(edge_ij: torch.Tensor, nodes: int):
    """Each node's incident edges as one list (CSR): ``ptr`` (N + 1,) int32
    and ``entries`` (2E,) int32, node n's entries in
    ``entries[ptr[n]:ptr[n + 1]]``, an entry ``j < E`` for edge j where n
    is its source and ``E + j`` where n is its target; a node's sources
    first, each part in edge order, which is the order in which
    ``index_add_`` on the CPU adds them (``_segment_sum``). Padding edges
    at (0, 0) are node 0's twice. A stable sort on the device: no host
    read."""
    keys = torch.cat([edge_ij[:, 0], edge_ij[:, 1]])
    ordered, entries = torch.sort(keys, stable=True)
    ptr = torch.searchsorted(ordered, torch.arange(nodes + 1, dtype=keys.dtype,
                                                   device=keys.device))
    return ptr.to(torch.int32), entries.to(torch.int32)


def incidence_segment_sum(ga, gb, ptr, entries):
    """Σ over each node's incidence list of the edges' terms (``ga`` for an
    edge where the node is the source, ``gb`` where it is the target, both
    (E, 3)), added one entry after another in list order from zero: the
    kernel's order, and ``_segment_sum``'s on the CPU."""
    terms = torch.cat([ga, gb])[entries.long()]
    start = ptr[:-1].long()
    deg = ptr[1:].long() - start
    out = ga.new_zeros((ptr.shape[0] - 1, ga.shape[1]))
    for k in range(int(deg.max()) if deg.numel() else 0):
        has = (deg > k)[:, None]
        row = terms[torch.clamp(start + k, max=max(terms.shape[0] - 1, 0))]
        out = torch.where(has, out + row, out)
    return out


class _Geometry(ctypes.Structure):
    """``PcgGeometry`` of spa_pcg.cu."""

    _fields_ = [("nodes", ctypes.c_int), ("edges", ctypes.c_int),
                ("cluster", ctypes.c_int), ("threads", ctypes.c_int),
                ("node_span", ctypes.c_int), ("edge_span", ctypes.c_int),
                ("npt", ctypes.c_int), ("ept", ctypes.c_int),
                ("iters", ctypes.c_int), ("smem_bytes", ctypes.c_int),
                ("tol", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What launches at one shape, budget and device need, made once."""

    geometry: Geometry
    params: object            # a _Geometry
    params_ptr: int
    index: int                # the device's index


def _launcher(symbol: str, pointers: int):
    """The bound C function (the library is built at the first call)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load("spa_pcg"), symbol)
        fn.argtypes = [ctypes.c_void_p] * pointers
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _plan(nodes: int, edges: int, iters: int, tol: float, device) -> _Plan:
    key = (nodes, edges, iters, tol, device)
    plan = _plans.get(key)
    if plan is None:
        geo = geometry(nodes, edges)
        if geo is None:
            raise ValueError(f"spa_pcg: {nodes} nodes and {edges} edges exceed one cluster "
                             f"of {MAX_CLUSTER} CTAs ({MAX_CLUSTER * NODE_SPAN} nodes, "
                             f"{MAX_CLUSTER * EDGE_SPAN} edges)")
        params = _Geometry(geo.nodes, geo.edges, geo.cluster, geo.threads, geo.node_span,
                           geo.edge_span, geo.npt, geo.ept, int(iters), geo.smem_bytes,
                           float(tol))
        fits = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _launcher("spa_pcg_prepare", 2)(ctypes.addressof(params),
                                                  ctypes.addressof(fits))
        if err != 0 or fits.value < 1:
            raise RuntimeError(f"spa_pcg {geo}: the card cannot run it (CUDA error {err}, "
                               f"{fits.value} clusters at once)")
        if len(_plans) >= 256:
            _plans.clear()
        plan = _plans[key] = _Plan(geo, params, ctypes.addressof(params), device.index)
    return plan


def _count(shape: tuple):
    """Count one launch at ``shape`` (nodes, edges), under
    ``launch.count_lock``."""
    global pcg_launches
    with launch.count_lock:
        pcg_launches += 1
        pcg_shapes[shape] += 1


def pcg(ja, jb, info, gauge, pinv, b, lam, done, edge_ij, ptr, entries, iters: int,
        tol: float):
    """x (N, 3) and the CG steps taken (() int32) of (H + λ·gauge) x = b:
    ``ja`` / ``jb`` (E, 3, 3) the edges' Jacobians as ``edge_jacobians``
    builds them, ``info`` (E, 3, 3) their information (zero on padding
    edges), ``gauge`` (N, 1), ``pinv`` (N, 3, 3) the preconditioner's
    blocks, ``b`` (N, 3), ``lam`` () the damping, ``done`` () bool (set: no
    step, x = 0), ``edge_ij`` (E, 2) int64, ``ptr`` / ``entries`` the
    incidence lists (``incidence``). On the card one launch on the current
    stream: no allocation but the outputs', no synchronisation, so it
    captures into a CUDA graph. Tensors off the card raise."""
    if not b.is_cuda:
        raise ValueError(f"spa_pcg: the kernel runs on the card, not on {b.device} tensors")
    dev = b.device
    n, e = b.shape[0], edge_ij.shape[0]
    plan = _plan(n, e, iters, tol, dev)
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("ja", ja, f32, (e, 3, 3)), ("jb", jb, f32, (e, 3, 3)),
            ("info", info, f32, (e, 3, 3)), ("gauge", gauge, f32, (n, 1)),
            ("pinv", pinv, f32, (n, 3, 3)), ("b", b, f32, (n, 3)), ("lam", lam, f32, ()),
            ("done", done, torch.bool, ()), ("edge_ij", edge_ij, torch.int64, (e, 2)),
            ("ptr", ptr, torch.int32, (n + 1,)), ("entries", entries, torch.int32, (2 * e,))):
        build.check_tensor(name, t, dtype, shape, dev)
    x = torch.empty_like(b)
    steps = torch.empty((), dtype=torch.int32, device=dev)
    err = launch.call(_launcher("spa_pcg_launch", 15), plan.index, ja.data_ptr(),
                      jb.data_ptr(), info.data_ptr(), gauge.data_ptr(), pinv.data_ptr(),
                      b.data_ptr(), lam.data_ptr(), done.data_ptr(), edge_ij.data_ptr(),
                      ptr.data_ptr(), entries.data_ptr(), x.data_ptr(), steps.data_ptr(),
                      plan.params_ptr)
    if err != 0:
        raise RuntimeError(f"spa_pcg {plan.geometry}: launch failed (CUDA error {err})")
    launch.counted(_count, (n, e))
    return x, steps


def ptxas_report() -> list[str]:
    """What ptxas says of every instantiation of the kernel (registers,
    shared memory, spills). Needs ``nvcc``."""
    return build.ptxas_report("spa_pcg")
