"""Wrapper of the correlation scoring CUDA kernel (``correlation.cu``).

``correlation_scores`` launches the kernel for tensors on the card and takes
the plain PyTorch version (``ops.correlative.correlation_scores_plain``) only
for CPU tensors. There is no fallback: on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0      # kernel launches so far (incremented only where it launches)

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("correlation").correlation_scores_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def correlation_scores(probs, rx, ry, svalid, xs, ys, default_prob: float,
                       divisor):
    """scores (B,A,N,N) f32, indexed [a, kx, ky]:
    ``(Σ_s probs[b, gy, gx]) / divisor[b]`` with
    ``gx = floor(rx[b,a,s] + xs[b,kx] + 0.5)``, ``gy`` likewise; invalid
    samples add exact 0, out-of-map cells add ``default_prob``.

    probs (B,H,W) f32, rx/ry (B,A,S) f32, svalid (B,S) bool, xs/ys (B,N)
    f32, divisor (B,) f32 — all contiguous and on one device."""
    if probs.dim() != 3 or rx.dim() != 3 or xs.dim() != 2:
        raise ValueError("correlation_scores: probs (B,H,W), rx (B,A,S), xs (B,N)")
    if not probs.is_cuda:
        from ..correlative import correlation_scores_plain

        return correlation_scores_plain(probs, rx, ry, svalid, xs, ys,
                                        default_prob, divisor)
    global launches
    B, H, W = probs.shape
    _, A, S = rx.shape
    N = xs.shape[1]
    dev = probs.device
    build.check_tensor("probs", probs, torch.float32, (B, H, W), dev)
    build.check_tensor("rx", rx, torch.float32, (B, A, S), dev)
    build.check_tensor("ry", ry, torch.float32, (B, A, S), dev)
    build.check_tensor("svalid", svalid, torch.bool, (B, S), dev)
    build.check_tensor("xs", xs, torch.float32, (B, N), dev)
    build.check_tensor("ys", ys, torch.float32, (B, N), dev)
    build.check_tensor("divisor", divisor, torch.float32, (B,), dev)
    scores = torch.empty((B, A, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(
            probs.data_ptr(), rx.data_ptr(), ry.data_ptr(), svalid.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), divisor.data_ptr(),
            scores.data_ptr(), B, A, S, N, H, W, float(default_prob),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"correlation_scores: kernel launch failed (CUDA error {err})")
    launches += 1
    return scores
