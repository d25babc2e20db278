"""Timing on the card.

Two kinds of protocol:

- **End to end, a chain of dependent calls** (``k_slope``,
  ``k_slope_dynamic``): the workload runs K chained iterations, each
  consuming the previous one's result, and returns one scalar, which is
  fetched to the host (``.cpu()``, which waits for the device). The time per
  iteration is the two-point slope ``(t(K2) - t(K1)) / (K2 - K1)`` of the
  best of ``reps`` host-clock runs at each K: the fixed cost of a run (the
  first launch, the final fetch, allocator warm-up) cancels in the
  difference. What the slope measures is whichever of the host's launches
  and the device's work sets the pace of the chain.
- **One call** (``time_ms``, ``device_us``, ``host_us``; ``in_turns`` to
  compare several fairly): CUDA events round back-to-back calls, a CUDA
  graph of 100 launches (device time with no host work between launches),
  the host's clock with no synchronise inside the window.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def _fetch(out):
    """The iteration chain's result on the host: waits for the device."""
    return torch.as_tensor(out).cpu()


def k_slope_dynamic(f: Callable, k_points: tuple[int, int] = (16, 64),
                    reps: int = 3, deadline: float | None = None,
                    log=None, partial_out: dict | None = None
                    ) -> tuple[float, dict]:
    """Seconds per iteration via the two-point K slope, where ``f(seed, K)``
    runs K chained iterations and returns a scalar. Each K point is warmed
    once, then timed ``reps`` times; the best time counts.

    ``deadline`` (a ``time.monotonic`` value) cuts the reps of a K point to
    one once past it. Returns (sec_per_iter, detail) where detail carries the
    best time per K point and every rep's time; ``partial_out`` receives each
    K point's best as soon as it is known."""
    k1, k2 = k_points
    assert k2 > k1 > 0
    _fetch(f(0, k1))                       # first call: builds, warms
    if log:
        log("compile+warm done")
    totals = {}
    rep_times: dict = {}
    for k in (k1, k2):
        _fetch(f(1009 + k, k))             # warm this trip count
        best = float("inf")
        r = reps
        if deadline is not None and time.monotonic() > deadline:
            r = 1
        times = []
        for i in range(r):
            t0 = time.perf_counter()
            _fetch(f(7 * i + k, k))
            times.append(time.perf_counter() - t0)
            best = min(best, times[-1])
        totals[k] = best
        rep_times[k] = times
        if partial_out is not None:
            partial_out[k] = best
        if log:
            log(f"K={k}: best {best:.4f}s over {r} reps")
    sec = max((totals[k2] - totals[k1]) / (k2 - k1), 1e-12)
    return sec, {"t_k1": totals[k1], "t_k2": totals[k2],
                 "k_points": k_points, "rep_times": rep_times}


def k_slope(make_chain: Callable[[int], Callable],
            k_points: tuple[int, int] = (16, 64),
            reps: int = 3) -> float:
    """Seconds per iteration via the two-point K slope, with one chain
    function per K point: ``make_chain(K)`` returns ``f(seed) -> scalar``
    that runs K chained iterations. Each is warmed once, then timed ``reps``
    times; the best counts."""
    k1, k2 = k_points
    assert k2 > k1 > 0
    totals = {}
    for k in (k1, k2):
        f = make_chain(k)
        _fetch(f(0))                           # warm
        best = float("inf")
        for i in range(reps):
            t0 = time.perf_counter()
            _fetch(f(i + 1))
            best = min(best, time.perf_counter() - t0)
        totals[k] = best
    return max((totals[k2] - totals[k1]) / (k2 - k1), 1e-12)


def time_ms(fn, reps: int = 20, warm: int = 5, inner: int = 10) -> float:
    """Time of one ``fn`` call on the card in ms: CUDA events around a run of
    ``inner`` back-to-back calls, warm, median over ``reps`` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def device_us(fn, launches: int = 100) -> float:
    """Device time of one ``fn`` call in microseconds: ``launches`` calls
    captured into one CUDA graph, the graph replayed between two events (no
    host work between the launches), median of 7 replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / launches * 1e3)
    return statistics.median(out)


def host_us(fn, calls: int = 200) -> float:
    """Host time of one ``fn`` call in microseconds: the host's clock round
    ``calls`` back-to-back calls, warm, no synchronise inside the window."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def in_turns(measure, fns: dict, order) -> dict:
    """``measure(fn)`` for every name of ``order`` in that order (a name may
    come more than once); the mean per name. Two functions are compared
    fairly only inside one run and in turns: a, b, b, a."""
    seen = {name: [] for name in fns}
    for name in order:
        seen[name].append(measure(fns[name]))
    return {name: statistics.mean(v) for name, v in seen.items()}
