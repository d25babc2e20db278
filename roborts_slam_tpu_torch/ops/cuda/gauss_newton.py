"""Wrapper of the Gauss-Newton match kernel (``gauss_newton.cu``, K6).

``match`` runs every pass of the optimize matcher on a batch of maps — the
bilinear lookups, the Jacobian, the sums of the normal equations, the 3x3
solve, the clamped step and the plateau stop, each map stopping on its own
test — in one launch on the card. There is no fallback and no CPU version:
it launches the kernel or raises. ``ops/gauss_newton.py::
optimize_passes_plain`` is the plain version its tests on the card hold it
against; the world↔map conversions and the empty-scan guard stay in
PyTorch around the launch (``ops/gauss_newton.py::optimize_scan_match``).

The launch geometry (``geometry``: one block a map, the scan's points
shared by a block's threads) follows from the shapes alone, so a launch has
a fixed shape and reads nothing: it captures into a CUDA graph.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch

from . import build, launch

gn_launches = 0     # kernel launches so far, and by (B, P, H, W):
gn_shapes: collections.Counter = collections.Counter()
# both are counted by ``_count``, under ``launch.count_lock``

THREADS = 256       # kThreads of gauss_newton.cu

_fn = None
_plans: dict[tuple, "_Params"] = {}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch: ``blocks`` blocks of ``threads`` threads, block b on map
    b (``map_stride`` floats from the last, 0 where one map serves the
    whole batch), thread t of a block on points t, t + threads, ... (up to
    ``points_per_thread`` of them)."""

    blocks: int
    threads: int
    map_stride: int
    points_per_thread: int


def geometry(batch: int, maps: int, points: int, height: int, width: int) -> Geometry:
    """The launch geometry of ``batch`` poses on ``maps`` maps (1, shared,
    or ``batch``) of ``height`` x ``width`` cells, for a scan of ``points``
    point slots."""
    if min(batch, points, height, width) < 1 or maps not in (1, batch):
        raise ValueError(f"gauss_newton: {batch} poses on {maps} maps of "
                         f"{height}x{width}, {points} points")
    return Geometry(batch, THREADS, 0 if maps == 1 else height * width,
                    -(-points // THREADS))


class _Params(ctypes.Structure):
    """``GnParams`` of gauss_newton.cu."""

    _fields_ = [("batch", ctypes.c_int), ("points", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("map_stride", ctypes.c_longlong), ("iters", ctypes.c_int),
                ("inv_res", ctypes.c_float), ("cost_decrease", ctypes.c_float),
                ("cost_min", ctypes.c_float), ("max_d", ctypes.c_float),
                ("max_angle", ctypes.c_float)]


def _launcher():
    """The bound C function (the library is built at the first call)."""
    global _fn
    if _fn is None:
        fn = build.load("gauss_newton").gauss_newton_launch
        fn.argtypes = [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _params(geo: Geometry, points: int, H: int, W: int, inv_res: float, params) -> _Params:
    key = (geo, points, H, W, inv_res, params)
    p = _plans.get(key)
    if p is None:
        if len(_plans) >= 256:
            _plans.clear()
        p = _plans[key] = _Params(
            geo.blocks, points, H, W, geo.map_stride, int(params.iterate_max_times),
            inv_res, params.cost_decrease_threshold, params.cost_min_threshold,
            params.max_update_distance * inv_res, params.max_update_angle)
    return p


def _count(shape: tuple):
    """Count one launch at ``shape`` (B, P, H, W), under ``launch.count_lock``."""
    global gn_launches
    with launch.count_lock:
        gn_launches += 1
        gn_shapes[shape] += 1


def match(probs, points, mask, pose0, inv_res: float, params):
    """Pose (B, 3) in map cells, cost (B,) and passes run (B,) int32 of the
    optimize matcher from ``pose0`` (B, 3) in map cells: ``probs`` (H, W),
    one map for every pose, or (B, H, W); ``points`` (P, 2) sensor-local
    metres and ``mask`` (P,) bool, shared; ``inv_res`` the map's cells per
    metre; ``params`` an ``OptimizeParams``. On the card one launch on the
    current stream: no allocation but the outputs', no synchronisation, so
    it captures into a CUDA graph. Tensors off the card raise."""
    if not probs.is_cuda:
        raise ValueError(f"gauss_newton: the kernel runs on the card, not on {probs.device} tensors")
    dev = probs.device
    H, W = probs.shape[-2:]
    B, P = pose0.shape[0], points.shape[0]
    maps = probs.shape[0] if probs.dim() == 3 else 1
    geo = geometry(B, maps, P, H, W)
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("probs", probs, f32, (maps, H, W) if probs.dim() == 3 else (H, W)),
            ("points", points, f32, (P, 2)), ("mask", mask, torch.bool, (P,)),
            ("pose0", pose0, f32, (B, 3))):
        build.check_tensor(name, t, dtype, shape, dev)
    pose = torch.empty((B, 3), dtype=f32, device=dev)
    cost = torch.empty((B,), dtype=f32, device=dev)
    passes = torch.empty((B,), dtype=torch.int32, device=dev)
    par = _params(geo, P, H, W, float(inv_res), params)
    err = launch.call(_launcher(), dev.index, probs.data_ptr(), points.data_ptr(),
                      mask.data_ptr(), pose0.data_ptr(), pose.data_ptr(), cost.data_ptr(),
                      passes.data_ptr(), ctypes.addressof(par))
    if err != 0:
        raise RuntimeError(f"gauss_newton {geo}: launch failed (CUDA error {err})")
    launch.counted(_count, (B, P, H, W))
    return pose, cost, passes


def ptxas_report() -> list[str]:
    """What ptxas says of the kernel (registers, shared memory, spills).
    Needs ``nvcc``."""
    return build.ptxas_report("gauss_newton")
