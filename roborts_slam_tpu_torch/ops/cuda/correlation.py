"""Wrappers of the two correlation scoring CUDA kernels.

``correlation_scores`` (``correlation.cu``) and ``correlation_scores_v2``
(``correlation_v2.cu``) compute the same function with the same arguments;
the second shares the cell-index arithmetic between the candidates of a
window. ``kernel_version()`` says which one the matcher uses: the
environment variable ``ROBORTS_CORR_KERNEL`` (default 1), as in the JAX
package. Each wrapper launches its kernel for tensors on the card and takes
the plain PyTorch version (``ops.correlative.correlation_scores_plain``, the
one plain version beside both kernels) only for CPU tensors. There is no
fallback: on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import os

import torch

from . import build

launches = 0      # launches of the first kernel (incremented only where it launches)
launches_v2 = 0   # launches of the second kernel
# the same launches by shape: (kernel version, B, A, S, N, H, W) -> count
launch_shapes: collections.Counter = collections.Counter()

_V2_ENV = "ROBORTS_CORR_KERNEL"
_SHARED_BYTES = 48 * 1024     # dynamic shared memory a block gets without opt-in
_V2_TILE = 512                # most samples staged per pass of the second kernel

_fns: dict[str, object] = {}


def kernel_version() -> int:
    """Which scoring kernel the matcher uses: ``ROBORTS_CORR_KERNEL`` as an
    integer, 1 when unset or not a number."""
    try:
        return int(os.environ.get(_V2_ENV, "1"))
    except ValueError:
        return 1


def scores_fn():
    """The ``correlation_scores``-shaped wrapper ``kernel_version()`` selects."""
    return correlation_scores_v2 if kernel_version() == 2 else correlation_scores


def _launcher(source: str, symbol: str, n_int: int):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(source), symbol)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check_dims(probs, rx, xs):
    if probs.dim() != 3 or rx.dim() != 3 or xs.dim() != 2:
        raise ValueError("correlation_scores: probs (B,H,W), rx (B,A,S), xs (B,N)")


def _checked_shapes(probs, rx, ry, svalid, xs, ys, divisor):
    """Raise unless the arguments are what the kernels take; returns
    (B, A, S, N, H, W)."""
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
    return B, A, S, N, H, W


def correlation_scores(probs, rx, ry, svalid, xs, ys, default_prob: float,
                       divisor):
    """scores (B,A,N,N) f32, indexed [a, kx, ky]:
    ``(Σ_s probs[b, gy, gx]) / divisor[b]`` with
    ``gx = floor(rx[b,a,s] + xs[b,kx] + 0.5)``, ``gy`` likewise; invalid
    samples add exact 0, out-of-map cells add ``default_prob``.

    probs (B,H,W) f32, rx/ry (B,A,S) f32, svalid (B,S) bool, xs/ys (B,N)
    f32, divisor (B,) f32 — all contiguous and on one device."""
    _check_dims(probs, rx, xs)
    if not probs.is_cuda:
        from ..correlative import correlation_scores_plain

        return correlation_scores_plain(probs, rx, ry, svalid, xs, ys,
                                        default_prob, divisor)
    global launches
    B, A, S, N, H, W = _checked_shapes(probs, rx, ry, svalid, xs, ys, divisor)
    dev = probs.device
    scores = torch.empty((B, A, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher("correlation", "correlation_scores_launch", 6)(
            probs.data_ptr(), rx.data_ptr(), ry.data_ptr(), svalid.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), divisor.data_ptr(),
            scores.data_ptr(), B, A, S, N, H, W, float(default_prob),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"correlation_scores: kernel launch failed (CUDA error {err})")
    launches += 1
    launch_shapes[(1, B, A, S, N, H, W)] += 1
    return scores


def correlation_scores_v2(probs, rx, ry, svalid, xs, ys, default_prob: float,
                          divisor):
    """The same function and arguments as ``correlation_scores``, computed
    by the second kernel (``correlation_v2.cu``): the column of every
    (sample, kx) and the row offset of every (sample, ky) are formed once in
    shared memory and shared by the N*N candidates of the window."""
    _check_dims(probs, rx, xs)
    if not probs.is_cuda:
        from ..correlative import correlation_scores_plain

        return correlation_scores_plain(probs, rx, ry, svalid, xs, ys,
                                        default_prob, divisor)
    global launches_v2
    B, A, S, N, H, W = _checked_shapes(probs, rx, ry, svalid, xs, ys, divisor)
    if S == 0:
        raise ValueError("correlation_scores_v2: empty sample axis (S = 0)")
    if H * W >= 2 ** 31:
        raise ValueError(f"correlation_scores_v2: map {H}x{W} too large for "
                         f"32-bit row offsets")
    tile = min(_V2_TILE, S, _SHARED_BYTES // (8 * N + 1))
    if tile < 1:
        raise ValueError(f"correlation_scores_v2: window side N={N} too large "
                         f"for the shared-memory tables")
    dev = probs.device
    scores = torch.empty((B, A, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher("correlation_v2", "correlation_scores_v2_launch", 7)(
            probs.data_ptr(), rx.data_ptr(), ry.data_ptr(), svalid.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), divisor.data_ptr(),
            scores.data_ptr(), B, A, S, N, H, W, tile, float(default_prob),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"correlation_scores_v2: kernel launch failed (CUDA error {err})")
    launches_v2 += 1
    launch_shapes[(2, B, A, S, N, H, W)] += 1
    return scores
