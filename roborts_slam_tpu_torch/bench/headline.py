"""The headline benchmark: correlative scan-match throughput (scans/s on one
card) against the measured single-core CPU baseline.

The workload (``bench/workload.py``) is the reference front end's per-scan
hot path: the 3-tier (coarse, fine, super-fine) correlative search on a
2048² fine map at 0.01 m with a 1081-beam scan. The card runs K
``frontend/matchers.scan_match`` calls in sequence, each starting from the
previous match's pose plus ``1e-6 · i`` (the online front end's dependency
chain), sums the scores on the device and fetches the sum once; the time per
match is the two-point K slope (``bench/timing.py::k_slope_dynamic``). Each
match is one replay of a CUDA graph of ``scan_match`` (``match_chain``), as
the JAX headline times K matches chained in one jitted program: the time is
the match's, not Python's launches (before it was graph-replayed, the same
slope measured the host's ≈ 520 launches a match). The
correlation kernel is the one ``ROBORTS_CORR_KERNEL`` selects (1 or 2) on
the card, the plain PyTorch version on CPU tensors. ``batch > 1`` matches
that many copies of the map side by side through ``scan_match``'s leading
batch dimension.

The baseline is ``native/baseline_correlative.cpp`` (the same tiers, map
content and scan, serial, ``-O2``), built with ``g++`` into the port's build
directory (``roborts_slam_tpu_torch/_build/``) at first use; the best of
three runs counts.

``headline()`` returns the one record ``python -m roborts_slam_tpu_torch
bench`` prints, with the roofline of ``bench/roofline.py`` against the
published peaks of the device it ran on.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ..ops.cuda import build

METRIC = "correlative_scan_match_throughput"
K_POINTS = (64, 256)          # matches chained at the two points of the slope
REPS = 5                      # timed runs per K point, the best counts
BASELINE_SRC = Path(__file__).resolve().parents[2] / "native" / "baseline_correlative.cpp"
BASELINE_FLAGS = ("-O2", "-std=c++17")


def baseline_binary() -> Path:
    """The CPU baseline's executable, built with ``g++`` if missing; named
    after the hash of the source and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(BASELINE_SRC.read_bytes()
                            + " ".join(BASELINE_FLAGS).encode()).hexdigest()[:16]
    exe = build.BUILD_DIR / f"baseline_correlative_{digest}"
    with build._lock:
        if not exe.exists():
            build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = exe.with_name(f"{exe.name}.tmp{os.getpid()}")
            subprocess.run(["g++", *BASELINE_FLAGS, "-o", str(tmp), str(BASELINE_SRC)],
                           check=True, capture_output=True)
            os.replace(tmp, exe)
    return exe


def cpu_baseline_scans_per_sec(beams: int = 1081, iters: int = 20) -> float:
    """Scans/s of the serial CPU baseline on the default workload (hash map,
    sinusoid scan): the best of three runs of ``iters`` scans."""
    cmd = [str(baseline_binary()), str(beams), str(iters)]

    def once() -> float:
        out = subprocess.run(cmd, check=True, capture_output=True, text=True).stdout
        for line in out.splitlines():
            if line.startswith("cpu_scans_per_sec"):
                return float(line.split()[1])
        raise RuntimeError(f"unexpected baseline output: {out!r}")

    return max(once() for _ in range(3))


def match_chain(w: dict, batch: int = 1, graph: bool = True):
    """``f(seed, K)``: K sequential ``scan_match`` calls on workload ``w``,
    each from the previous pose plus ``1e-6 · i``; returns the sum of the
    scores as a device scalar. The carried pose, ``i`` and the sum live in
    device buffers and ``1e-6 · i`` is added on the device, so a match reads
    nothing: on the card (``graph``) one match is captured in a CUDA graph
    at the chain's second match and replayed from then on, the counterpart
    of the JAX headline's one jitted ``fori_loop``; with ``graph=False``, or
    on the CPU, every match launches eagerly (the yardstick). The seed is
    not used: nothing on the card memoizes a repeated call."""
    from ..frontend.matchers import scan_match
    from ..ops.correlative import valid_count
    from ..step_graph import StepGraph

    fine, coarse = w["fine_probs"], w["coarse_probs"]
    offset, coff, init = w["offset"], w["coff"], w["init_pose"]
    if batch > 1:
        fine = fine.expand(batch, *fine.shape).contiguous()
        coarse = coarse.expand(batch, *coarse.shape).contiguous()
        offset, coff = offset.expand(batch, 2), coff.expand(batch, 2)
        init = init.expand(batch, 3)
    dev = fine.device
    n_valid = valid_count(w["n_valid"], dev)
    pose = init.clone()
    i = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)

    def one(_staged=None):
        out = scan_match(w["matcher"], w["fine_spec"], fine, offset,
                         w["coarse_spec"], coarse, coff, w["points"],
                         w["mask"], n_valid, pose)
        # 1e-6 · i in float64, then float32: Python's product, as the
        # scalar a float32 tensor adds
        pose.copy_(out.pose + (i.double() * 1e-6).float())
        i.add_(1)
        acc.add_(out.score.sum())
        return acc

    step = StepGraph(one, 1, dev, capture=graph)

    def f(seed, K):
        pose.copy_(init)
        i.zero_()
        acc.zero_()
        for _ in range(K):
            step()
        return acc.clone()

    f.step = step
    return f


def headline(beams: int = 1081, batch: int = 1, k_points=None, reps=None,
             device=None, log=None, baseline: float | None = None) -> dict:
    """The headline record: scans/s on ``device`` (``None``: the card;
    raises without one), the CPU baseline (measured unless ``baseline`` is
    given) and their ratio, every rep's time per K point and their spread,
    and the roofline of the measured time per match."""
    from .roofline import roofline_summary, scan_match_cost
    from .timing import k_slope_dynamic
    from .workload import headline_workload
    from ..ops.cuda.correlation import kernel_version

    k_points = K_POINTS if k_points is None else tuple(k_points)
    reps = REPS if reps is None else reps
    w = headline_workload(beams, device=device)
    if baseline is None:
        baseline = cpu_baseline_scans_per_sec(beams=beams)
        if log:
            log(f"cpu baseline {baseline:.1f} scans/s")
    dev = w["fine_probs"].device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    per_match, detail = k_slope_dynamic(match_chain(w, batch), k_points=k_points,
                                        reps=reps, log=log)
    rate = batch / per_match
    cost = scan_match_cost(w["matcher"], w["fine_spec"], w["points"], w["n_valid"],
                           w["init_pose"], w["offset"], batch=batch)
    roof = roofline_summary(cost, per_match, device_kind=kind)
    spread = [(max(v) - min(v)) / max(min(v), 1e-9)
              for v in detail["rep_times"].values() if v]
    return {
        "metric": METRIC, "value": rate, "unit": "scans/sec/chip",
        "vs_baseline": rate / baseline,
        "baseline_scans_per_sec": baseline,
        "device": kind, "corr_kernel": kernel_version() if dev.type == "cuda" else None,
        "batch": batch, "k_points": list(k_points),
        "rep_times_s": {str(k): v for k, v in detail["rep_times"].items()},
        "rep_spread": max(spread) if spread else None,
        "match_us": roof["match_us"],
        "hbm_frac_of_peak": roof["hbm_frac"],
        "achieved_gbps": roof["achieved_gbps"],
        "gops_per_s": roof["achieved_gops"],
        "f32_frac_of_peak": roof["ops_frac"],
        "bound_us": roof["bound_us"], "bound_by": roof["bound_by"],
    }
