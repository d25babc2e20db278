"""The Gauss-Newton match kernel's device time per match in the profiled
slice, in microseconds: the time of the kernels whose names match
``PATTERN`` in the calls ``gn_cost.counted_calls`` counts (replayed programs
alone, one launch a match group) over the matches those calls ran (the
front-end match where a call stepped, ``B`` for each chain batch of ``B``
chains). A program that runs the plain loop gives no value."""

PATTERN = r"gauss_newton_match_kernel"


def read(ctx):
    from lib import gn_cost

    rows = gn_cost.counted_calls(ctx, PATTERN)
    matches = sum(m for _, m, _ in rows)
    return 1e6 * sum(s for s, _, _ in rows) / matches if matches else None
