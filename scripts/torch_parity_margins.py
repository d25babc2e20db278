#!/usr/bin/env python3
"""How far the port's free-running parity tests are from their bars, on
the CPU.

    python scripts/torch_parity_margins.py [--only engine,cli_default] [--variants 0,10]
    python scripts/torch_parity_margins.py --table runs/*.jsonl [--before earlier/*.jsonl]

Each free-running comparison of the port against the JAX package that the
tests hold (``tests/test_torch_*.py``) is run over eight variants of its
input: a start offset into ``tests/data/golden_icra.npz`` where the log is
recorded, an odometry-noise seed where it is simulated. The first variant of
each is the test's own input. Each test module defines its run as
``free_run`` (``free_replay`` for the 12-step front-end replay) and its
variants as ``VARIANTS``; this script calls them.

One JSON line per comparison, phase and variant: the poses beyond 2e-3 m /
2e-3 rad on the shared kept scans, the largest and median gap, the first
fed scan at which the runs part (a kept decision that differs, or a pose
beyond 2e-3), kept ids, links, closures and solves of both, ATE or the RMS
gap to JAX, whether the bar the test held before this form passes
(``old_bar``), and the bars of a free case (``parity.compare_free``:
``free_failed``). The replay reports its per-step gaps against its 3e-5 m
bar. One torch thread, JAX on the CPU; a run takes seconds to a minute.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np      # noqa: E402

from roborts_slam_tpu_torch.bench import parity  # noqa: E402

SUPER_FINE_STEP = 0.01      # m, the simulation profile's super-fine step


def _old_bar(jrec, trec, max_m=SUPER_FINE_STEP, max_rad=0.00349, median_m=None,
             outliers=True, counts=False) -> bool:
    """The bar of the tests before the lockstep form: the same kept scans,
    where ``outliers`` at most 3 poses beyond 2e-3 m / 2e-3 rad, none
    beyond ``max_m`` / ``max_rad``, the median within ``median_m`` (m, and
    rad where ``outliers`` is off) where given, and where ``counts`` the
    same links and closures."""
    if not np.array_equal(jrec["kept_ids"], trec["kept_ids"]):
        return False
    if counts and (jrec["links"], jrec["closures"]) != (trec["links"], trec["closures"]):
        return False
    d = parity.pose_gap(np.asarray(trec["poses"]), np.asarray(jrec["poses"]))
    if outliers and ((d[:, 0] > parity.POS_TOL) | (d[:, 1] > parity.ANG_TOL)).sum() > 3:
        return False
    if d[:, 0].max() > max_m or d[:, 1].max() > max_rad:
        return False
    if median_m is not None and np.median(d[:, 0]) > median_m:
        return False
    return outliers or median_m is None or np.median(d[:, 1]) <= median_m


def _row(name, phase, variant, jrec, trec, old) -> dict:
    report, failed = parity.compare_free(trec, jrec)
    d = parity.pose_gap(np.asarray(trec["poses"])[np.isin(trec["kept_ids"], jrec["kept_ids"])],
                        np.asarray(jrec["poses"])[np.isin(jrec["kept_ids"], trec["kept_ids"])])
    return {"comparison": name, "phase": phase, "variant": variant,
            "beyond_2e-3": int(((d[:, 0] > parity.POS_TOL) | (d[:, 1] > parity.ANG_TOL)).sum()),
            "max_gap_m": float(d[:, 0].max()), "max_gap_rad": float(d[:, 1].max()),
            "median_gap_m": float(np.median(d[:, 0])),
            "first_parting_scan": report["first_parting_scan"],
            "kept": report["kept"], "kept_ids_equal": report["kept_decisions_differing"] == 0,
            "links": report["links"], "closures": report["closures"],
            "solves": report["solves"], "ate_m": report["ate_m"],
            "rms_gap_m": report["rms_gap_m"], "old_bar": bool(old),
            "free_failed": failed}


def _engine(v, tmp):
    from tests import test_torch_engine as m
    out = m.free_run(v)
    return [(p, *out[p], dict(median_m=1e-4)) for p in ("before_optimize", "after_optimize")]


def _checkpoint(pipelined):
    def run(v, tmp):
        from tests import test_torch_checkpoint as m
        j, t = m.free_run(v, pipelined)
        return [("end", j, t, dict(max_rad=np.inf))]
    return run


def _cli(profile):
    def run(v, tmp):
        from tests import test_torch_cli as m
        j, t, _, _ = m.free_run(v, profile, tmp)
        return [("end", j, t, {})]
    return run


def _fused(mode):
    def run(v, tmp):
        from tests import test_torch_fused_pipelined as m
        out = m.free_run(v, mode)
        return [("out", *out["out"], dict(max_rad=np.inf)),
                ("end", *out["end"], dict(max_rad=1e-2, median_m=1e-3, outliers=False,
                                          counts=True))]
    return run


def _run_stream(v, tmp):
    from tests import test_torch_io_readers as m
    j, t, _ = m.free_run(v, tmp)
    return [("end", j, t, dict(max_rad=np.inf))]


def _walk(v, tmp):
    from tests import test_torch_windowed_recenter as m
    j, t = m.free_run(v)
    return [("end", j, t, {})]


def _leg3(v, tmp):
    from tests import test_torch_full_width as m
    j, t = m.free_run(v)
    return [("end", j, t, dict(median_m=1e-4))]


COMPARISONS = {
    "engine": ("tests.test_torch_engine", _engine),
    "checkpoint_in_the_port": ("tests.test_torch_checkpoint", _checkpoint(False)),
    "checkpoint_into_a_pipelined_port": ("tests.test_torch_checkpoint", _checkpoint(True)),
    "cli_default": ("tests.test_torch_cli", _cli("default")),
    "cli_real_robot": ("tests.test_torch_cli", _cli("real_robot")),
    "fused": ("tests.test_torch_fused_pipelined", _fused("fused")),
    "pipelined": ("tests.test_torch_fused_pipelined", _fused("pipelined")),
    "run_stream": ("tests.test_torch_io_readers", _run_stream),
    "corridor_walk": ("tests.test_torch_windowed_recenter", _walk),
    "leg3_first_36": ("tests.test_torch_full_width", _leg3),
    "replay_12": ("tests.test_torch_matchers_frontend", None),
}


def _variants(module):
    import importlib

    return importlib.import_module(module).VARIANTS


def _cells(paths) -> dict:
    """{(comparison, phase): {variant: (cell text, old bar failed)}} of the
    JSON lines this script printed (files given)."""
    by: dict = {}
    for r in (json.loads(line) for p in paths for line in open(p) if line.strip()):
        if r["phase"] == "steps":
            t = f"{r['steps_beyond_3e-5']}:{r['max_gap_m'] * 1e3:.3f}"
        else:
            part = r["first_parting_scan"]
            t = (f"{r['beyond_2e-3']}:{r['max_gap_m'] * 1e3:.2f}@{'-' if part is None else part}"
                 + ("F" if r["free_failed"] else "") + ("" if r["kept_ids_equal"] else "k"))
        by.setdefault((r["comparison"], r["phase"]), {})[r["variant"]] = (
            t + ("" if r["old_bar"] else "✗"), not r["old_bar"])
    return by


def table(paths, before=None) -> str:
    """The markdown table of JSON lines this script printed (files given):
    one row per comparison and phase, one cell per variant, ``n:max@k``
    with n the poses beyond 2e-3 m / 2e-3 rad, max the largest gap in mm
    and k the first parting fed scan (- where none); the replay ``n:max``
    with n its steps beyond 3e-5 m. ✗: the test's bar before the lockstep
    form fails; F: a bar of ``parity.compare_free`` fails; k: kept ids
    differ. Last column: the variants whose old bar fails. With ``before``
    (files of an earlier run) each cell reads "earlier → these"."""
    now, was = _cells(paths), (_cells(before) if before else None)
    out = []
    for key, cells in now.items():
        txt = [c[0] if was is None else f"{was[key][v][0]} → {c[0]}" for v, c in cells.items()]
        fails = f"{sum(c[1] for c in cells.values())}/{len(cells)}"
        if was is not None:
            fails = f"{sum(c[1] for c in was[key].values())}/{len(cells)} → {fails}"
        out.append(f"| {' '.join(key)} | {' | '.join(txt)} | {fails} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(COMPARISONS))
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants (default: the module's eight)")
    ap.add_argument("--table", nargs="+", metavar="JSONL",
                    help="print the markdown table of earlier runs' lines instead")
    ap.add_argument("--before", nargs="+", metavar="JSONL",
                    help="with --table: an earlier run's lines, each cell 'earlier -> these'")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table, args.before))
        return 0
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    for name in args.only.split(","):
        module, run = COMPARISONS[name]
        variants = ([int(v) for v in args.variants.split(",")] if args.variants
                    else _variants(module))
        for v in variants:
            t0 = time.perf_counter()
            if run is None:
                from tests import test_torch_matchers_frontend as m
                g = m.free_replay(v)
                over = np.flatnonzero(g.max(1) > 3e-5)
                row = {"comparison": name, "phase": "steps", "variant": v,
                       "max_gap_m": float(g[:, 0].max()), "max_gap_rad": float(g[:, 1].max()),
                       "steps_beyond_3e-5": int(over.size),
                       "first_step_beyond_3e-5": int(over[0]) if over.size else None,
                       "old_bar": bool(over.size == 0)}
                print(json.dumps({**row, "seconds": time.perf_counter() - t0}), flush=True)
                continue
            with tempfile.TemporaryDirectory() as tmp:
                rows = run(v, tmp)
            for phase, jrec, trec, old in rows:
                row = _row(name, phase, v, jrec, trec, _old_bar(jrec, trec, **old))
                print(json.dumps({**row, "seconds": time.perf_counter() - t0},
                                 default=lambda o: o.tolist() if hasattr(o, "tolist") else o),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
