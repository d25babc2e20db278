"""Tracing / profiling.

Own copy of the JAX package's ``utils/profiling.py`` for the port:

- ``StageTimers``: always-on named wall-clock accumulators (count/total/max)
  that the engine threads through its stages. Both engine threads (the front
  end and the asynchronous back-end worker) add to one instance, so an
  accumulation takes a lock. ``stage(name)`` is the port's one span: while a
  ``torch.profiler`` records, it is also a ``record_function`` named
  ``slam.<name>`` in the trace, on the clock of the device's activity; when
  none records it opens nothing there (``record_function`` costs ~13 us a
  span even with the profiler off). ``root`` labels a region in the trace
  only (the engine's per-scan and per-pass spans). With ``device_timing``
  set, ``device_start`` / ``device_stop`` time replayed programs on the
  device with CUDA event pairs, resolved into ``device.<what>`` stages
  after a host read that waited for them anyway (``device_resolve``).
- ``trace``: a thin wrapper over ``torch.profiler`` that writes a Chrome
  trace (``chrome://tracing``, Perfetto) of the enclosed block, host and
  device, holding the stages' spans. It costs nothing when no trace is being
  taken.
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

from torch.autograd import profiler as _autograd_profiler


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


_clock = time.perf_counter


class _Span:
    """One entry of ``StageTimers.stage``: a slotted context manager (a
    ``contextlib`` generator costs about twice as much a span). Whether a
    ``torch.profiler`` records is a module flag torch keeps for such checks
    (a tenth of a microsecond)."""

    __slots__ = ("_timers", "_name", "_t0", "_rf")

    def __init__(self, timers: "StageTimers", name: str):
        self._timers, self._name, self._t0, self._rf = timers, name, None, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function("slam." + self._name)
            self._rf.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:            # never entered: nothing to close
            return False
        dt = _clock() - self._t0
        self._t0 = None
        timers = self._timers
        with timers._lock:              # StageStat.add, inlined
            st = timers.stages[self._name]
            st.count += 1
            st.total_s += dt
            if dt > st.max_s:
                st.max_s = dt
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        return False


class StageTimers:
    """Named stage accumulators, safe to add to from several threads.

    ``device_timing`` (off by default): ``device_start`` / ``device_stop``
    record a CUDA event pair, taken from a pool, on the launching stream
    round a program's replay; ``device_resolve``, called after a host read
    that has waited for the stream, adds each finished pair's device
    seconds to its stage. Nothing here synchronises; a pair that has not
    finished waits for the next resolve. Off, or on CPU tensors, they do
    nothing."""

    def __init__(self):
        self.stages: dict[str, StageStat] = defaultdict(StageStat)
        self._lock = threading.Lock()
        self.device_timing = False
        self._pending: list = []           # (stage, start, end) recorded, not resolved
        self._events: list = []            # the pool of timing events

    def stage(self, name: str) -> _Span:
        """A span of stage ``name``: ``with timers.stage(name): ...``."""
        return _Span(self, name)

    @staticmethod
    def root(what: str, ident) -> contextlib.AbstractContextManager:
        """A span ``slam.<what>/<ident>`` in the trace while a profiler
        records (nothing is accumulated, and no name is formatted
        otherwise)."""
        if _autograd_profiler._is_profiler_enabled:
            return _autograd_profiler.record_function(f"slam.{what}/{ident}")
        return _NULL

    def device_start(self, device):
        """A started event pair on ``device``'s current stream, or None
        (timing off, or not a CUDA device)."""
        if not self.device_timing or device.type != "cuda":
            return None
        import torch

        with self._lock:
            pair = [self._events.pop() if self._events else
                    torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair.append(torch.cuda.current_stream(device))
        pair[0].record(pair[2])
        return pair

    def device_stop(self, pair, stage: str, keep: bool = True):
        """End ``pair`` (from ``device_start``) and hold it for stage
        ``stage``; ``keep`` False (an eager call, a capture) returns it to
        the pool untimed."""
        if pair is None:
            return
        if not keep:
            with self._lock:
                self._events += pair[:2]
            return
        pair[1].record(pair[2])
        with self._lock:
            self._pending.append((stage, pair[0], pair[1]))

    def device_resolve(self):
        """Add every finished pending pair's device time to its stage
        (``Event.query`` does not wait)."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
            for stage, start, end in pending:
                if end.query():
                    self.stages[stage].add(1e-3 * start.elapsed_time(end))
                    self._events += (start, end)
                else:
                    self._pending.append((stage, start, end))

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


_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a host + device trace of the enclosed block and write it to
    ``logdir/trace.json`` (Chrome trace format), the spans of every thread
    included (the asynchronous back-end worker's) where the installed torch
    has the option (a profiler records its own thread only otherwise).
    ``logdir=None`` disables tracing. Yields the profiler (``None`` when
    disabled)."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    options = {}
    try:
        options["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        pass
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, **options) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
