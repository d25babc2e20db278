"""The 95th percentile (nearest rank) of the ``process()`` call durations,
host clock, over every scan fed in the window: each call ends in the
engine's read, and the calls that applied a loop closure are included."""

from lib.harness import p95


def read(ctx):
    d = ctx["durations"]
    return 1e3 * p95(d) if d else None
