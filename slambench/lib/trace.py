"""What a traced run reads from its ``torch.profiler`` trace: the device's
busy intervals, the kernels by name, the idle gaps by what the harness was
doing, and the kernels of each ``process()`` call.

The harness marks its own spans in the trace with ``record_function``
(``slambench.<what>``); the profiler puts them on the same clock as the
device's activity, so a gap on the device is named by the span that holds
its middle, and a kernel belongs to the call whose span holds its start (the
engine ends every step in a read, so a call's kernels run inside it; what a
correction launches last runs into the next span and is counted there).
"""

from __future__ import annotations

import bisect
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "slambench."


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def events(trace: dict):
    """(device activities [(start_us, end_us, name, cat)], harness spans
    [(start_us, end_us, name)]), each sorted by start."""
    dev, spans = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""), cat))
        elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            spans.append((ts, ts + dur, e["name"][len(SPAN_PREFIX):]))
    dev.sort()
    spans.sort()
    return dev, spans


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``intervals`` ((start, end, ...) sorted by start),
    clipped to [lo, hi], as disjoint (start, end) pairs."""
    out = []
    for a, b, *_ in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle (start, end) pairs of [lo, hi] between the ``busy`` pairs."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def cut(pairs: list, holes: list) -> list:
    """The disjoint sorted (start, end) ``pairs`` less the disjoint sorted
    ``holes``."""
    out = []
    for a, b in pairs:
        for h0, h1 in holes:
            if h1 <= a or h0 >= b:
                continue
            if h0 > a:
                out.append((a, h0))
            a = max(a, h1)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def span_at(spans: list, t: float, skip=("slice",)) -> str:
    """The innermost harness span that holds ``t`` (the latest started),
    or "harness" where none does."""
    best = None
    for a, b, name in spans:
        if a > t:
            break
        if a <= t <= b and name not in skip:
            best = name
    return best or "harness"


def read(trace: dict) -> dict:
    """The slice's numbers: its bounds (the ``slice`` span), its seconds and
    the device's busy seconds in it, both without the check's copies, the
    top device operations by time, the longest idle gaps named by the
    harness span they fall in, and the device activities and the
    ``process`` spans for the kernel readers."""
    dev, spans = events(trace)
    sl = [s for s in spans if s[2] == "slice"]
    if not sl or not dev:
        return {}
    lo, hi = sl[0][0], sl[0][1]
    # the check's copies (``sample`` spans) are the harness's work, kept out
    # of the window's time: out of the slice too, with what the device did then
    held = union([s for s in spans if s[2] == "sample"], lo, hi)
    busy = cut(union(dev, lo, hi), held)
    busy_us = sum(b - a for a, b in busy)
    by_name: dict = {}
    for a, b, name, _ in dev:
        if lo <= a <= hi:
            by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(short(n), v) for n, v in top]
    idle = sorted(cut(gaps(busy, lo, hi), held), key=lambda g: -(g[1] - g[0]))[:10]
    window_us = (hi - lo) - sum(b - a for a, b in held)
    return {"lo_us": lo, "hi_us": hi, "window_s": window_us * 1e-6, "busy_s": busy_us * 1e-6,
            "device_ops": [[n, s * 1e-6] for n, s in top],
            "idle_gaps": [[span_at(spans, (a + b) / 2), (b - a) * 1e-6] for a, b in idle],
            "dev": [d for d in dev if lo <= d[0] <= hi],
            "calls": [s for s in spans if s[2] == "process" and lo <= s[0] <= hi]}


def short(name: str, width: int = 96) -> str:
    """A kernel's name without ``void `` and cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def kernel_time_by_call(t: dict, pattern: str) -> list:
    """Seconds of the device kernels whose name matches ``pattern`` that
    started in each ``process`` call of the slice (up to the next call's
    start), one entry a call in order, and how many there were."""
    calls = t.get("calls", [])
    starts = [c[0] for c in calls]
    rx = re.compile(pattern)
    secs, count = [0.0] * len(calls), [0] * len(calls)
    for a, b, name, cat in t.get("dev", []):
        if cat != "kernel" or not rx.search(name):
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0:
            secs[i] += (b - a) * 1e-6
            count[i] += 1
    return list(zip(secs, count))
