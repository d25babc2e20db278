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
- ``DEVICE_PEAKS`` / ``roofline_report``: a kernel's achieved rates against
  the published peaks of the card it ran on, for the benchmark
  (``bench/``). The table is keyed by ``torch.cuda.get_device_name()``; a
  card that is not in it raises rather than borrowing another's peaks.
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


# ---- roofline accounting -------------------------------------------------

# Published peaks per device, keyed by ``torch.cuda.get_device_name()``.
# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
# (``nvidia-smi --query-gpu=name,power.limit`` prints "NVIDIA H100 80GB HBM3,
# 700.00 W" for this part): 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the
# tensor cores, 67 TFLOP/s in float32 outside them. ``cpu`` is a nominal
# entry so that a run on CPU tensors yields a report of the same keys; its
# fractions describe no device.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "f32_tflops": 67.0,
                              "hbm_gbps": 3350.0, "power_limit_w": 700.0},
    "cpu": {"bf16_tflops": 0.2, "f32_tflops": 0.2, "hbm_gbps": 20.0},
}


def device_peaks(device_kind: str | None = None) -> tuple[str, dict]:
    """``(kind, peaks)`` for ``device_kind`` (``None``: the current CUDA
    device; raises without one). An unknown device raises."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_kind='cpu' for a "
                               "run on CPU tensors")
        device_kind = torch.cuda.get_device_name()
    if device_kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}: add "
                       "them to utils/profiling.DEVICE_PEAKS")
    return device_kind, DEVICE_PEAKS[device_kind]


def roofline_report(kernel_name: str, seconds: float, flops: float,
                    bytes_moved: float, device_kind: str | None = None) -> dict:
    """Achieved vs peak throughput for one kernel invocation."""
    device_kind, peaks = device_peaks(device_kind)
    tflops = flops / seconds / 1e12
    gbps = bytes_moved / seconds / 1e9
    return {
        "kernel": kernel_name,
        "device": device_kind,
        "time_ms": 1000.0 * seconds,
        "achieved_tflops": tflops,
        "peak_tflops": peaks["bf16_tflops"],
        "flops_frac": tflops / peaks["bf16_tflops"],
        "achieved_gbps": gbps,
        "peak_gbps": peaks["hbm_gbps"],
        "bw_frac": gbps / peaks["hbm_gbps"],
        "bound": "memory" if gbps / peaks["hbm_gbps"] > tflops / peaks["bf16_tflops"]
                 else "compute",
    }
