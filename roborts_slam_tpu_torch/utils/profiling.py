"""Tracing / profiling.

Own copy of the JAX package's ``utils/profiling.py`` for the port:

- ``StageTimers``: always-on named wall-clock accumulators (count/total/max)
  that the engine threads through its stages. Both engine threads (the front
  end and the asynchronous back-end worker) add to one instance, so an
  accumulation takes a lock.
- ``trace`` / ``annotate``: thin wrappers over ``torch.profiler``. ``trace``
  writes a Chrome trace (``chrome://tracing``, Perfetto) of the enclosed
  block, host and device; ``annotate`` labels a region inside it. Both cost
  nothing when no trace is being taken.

The JAX copy's ``roofline_report`` holds TPU peaks and belongs with the
benchmark, which is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import defaultdict


@dataclasses.dataclass
class StageStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


class StageTimers:
    """Named stage accumulators, safe to add to from several threads."""

    def __init__(self):
        self.stages: dict[str, StageStat] = defaultdict(StageStat)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stages[name].add(dt)

    def report(self) -> str:
        lines = [f"{'stage':<26}{'count':>7}{'mean ms':>10}{'max ms':>10}{'total s':>10}"]
        with self._lock:
            stages = sorted(self.stages.items(), key=lambda kv: -kv[1].total_s)
        for name, s in stages:
            lines.append(f"{name:<26}{s.count:>7}{s.mean_ms:>10.2f}"
                         f"{1000 * s.max_s:>10.2f}{s.total_s:>10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        with self._lock:
            return {k: dataclasses.asdict(v) for k, v in self.stages.items()}


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a host + device trace of the enclosed block and write it to
    ``logdir/trace.json`` (Chrome trace format). ``logdir=None`` disables
    tracing. Yields the profiler (``None`` when disabled)."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Label a region inside a captured trace."""
    from torch.profiler import record_function

    return record_function(name)
