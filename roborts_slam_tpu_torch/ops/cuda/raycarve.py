"""Wrappers of the ray carving / ray checking CUDA kernels (``raycarve.cu``).

Each wrapper launches its kernel for tensors on the card and takes the plain
PyTorch version (``ops.raster.mark_image_plain`` /
``ops.raycast.bad_rays_plain``) only for CPU tensors. There is no fallback:
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

mark_launches = 0     # ray_mark_image kernel launches so far
check_launches = 0    # bad_ray_count kernel launches so far

_mark_fn = None
_check_fn = None


def _mark_launcher():
    global _mark_fn
    if _mark_fn is None:
        fn = build.load("raycarve").ray_mark_image_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _mark_fn = fn
    return _mark_fn


def _check_launcher():
    global _check_fn
    if _check_fn is None:
        fn = build.load("raycarve").bad_ray_count_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _check_fn = fn
    return _check_fn


def ray_mark_image(start, end, beam_mask, height: int, width: int):
    """Per-scan mark image (H, W) int32: 1 on each ray's free prefix
    ``t ∈ [0, n-1]``, 2 at endpoints, occupied beats free; out-of-map cells
    are dropped. start (2,) i32 [x, y], end (P,2) i32, beam_mask (P,) bool."""
    if not start.is_cuda:
        from ..raster import mark_image_plain

        return mark_image_plain(start, end, beam_mask, height, width)
    global mark_launches
    dev = start.device
    P = end.shape[0]
    build.check_tensor("start", start, torch.int32, (2,), dev)
    build.check_tensor("end", end, torch.int32, (P, 2), dev)
    build.check_tensor("beam_mask", beam_mask, torch.bool, (P,), dev)
    mark = torch.zeros((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _mark_launcher()(
            start.data_ptr(), end.data_ptr(), beam_mask.data_ptr(),
            P, height, width, mark.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ray_mark_image: kernel launch failed (CUDA error {err})")
    mark_launches += 1
    return mark


def bad_ray_count(start, end, ray_ok, hits, passes, min_passthrough: float,
                  occu_threshold: float, thr_d2: int):
    """(B,) int32 count of rays that visit, for ``t ∈ [0, n]``, an occupied
    cell (``passes >= min_passthrough`` and ``hits/passes >= occu_threshold``)
    with squared cell distance ``>= thr_d2`` from the endpoint.
    start (B,2) i32, end (B,S,2) i32, ray_ok (B,S) bool, hits/passes (H,W)
    f32."""
    if not start.is_cuda:
        from ..raycast import bad_rays_plain

        return bad_rays_plain(start, end, ray_ok, hits, passes,
                              min_passthrough, occu_threshold, thr_d2)
    global check_launches
    dev = start.device
    B, S = ray_ok.shape
    H, W = hits.shape
    build.check_tensor("start", start, torch.int32, (B, 2), dev)
    build.check_tensor("end", end, torch.int32, (B, S, 2), dev)
    build.check_tensor("ray_ok", ray_ok, torch.bool, (B, S), dev)
    build.check_tensor("hits", hits, torch.float32, (H, W), dev)
    build.check_tensor("passes", passes, torch.float32, (H, W), dev)
    out = torch.zeros((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _check_launcher()(
            start.data_ptr(), end.data_ptr(), ray_ok.data_ptr(),
            hits.data_ptr(), passes.data_ptr(), B, S, H, W,
            float(min_passthrough), float(occu_threshold), int(thr_d2),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bad_ray_count: kernel launch failed (CUDA error {err})")
    check_launches += 1
    return out
