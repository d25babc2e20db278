"""Seconds the window's loop closures spent capturing programs (a solve
program at a bucket's first solve, a rebuild program at its second
correction: ``diag.closure_capture_s``), per closure."""


def read(ctx):
    t = ctx["totals"]
    return 1e3 * t["closure_capture_s"] / t["loop_closures"] if t.get("loop_closures") else None
