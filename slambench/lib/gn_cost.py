"""Speed-of-light accounting for the Gauss-Newton match (the optimize
matcher) that the benchmark reads, kept here so that a change to the program
cannot move the yardstick.

A match is counted as ONE evaluation pass over the scan's valid points,
whatever number of passes an implementation runs before it stops: the least
any implementation must do. Per valid point a pass reads four neighbouring
map cells (4 bytes each) and the point (8 bytes); a match reads its start
pose and writes its pose (12 bytes each). Its operations per valid point,
counted in the plain version's arithmetic:

- the point scaled to cells and rotated onto the map: 2 + 8 = 10;
- the bilinear weights and the response: floors 2, corners 2, weights 4,
  the response 9, its clamp 2 = 19;
- the residual: 1;
- the Jacobian: the map's gradient 10, the rotation's 6, J 4 = 20;
- the sums of H (six entries), J^T e, e.e and the count: 12 + 6 + 2 + 1 = 21;

71 a point; and the 3x3 solve and the step's decision, 60 a match.
"""

from __future__ import annotations

BYTES_PER_POINT = 4 * 4 + 8
BYTES_PER_MATCH = 2 * 12
OPS_PER_POINT = 10 + 19 + 1 + 20 + 21
OPS_PER_MATCH = 60


def match_cost(n_valid: int, matches: int = 1) -> tuple[float, float]:
    """(bytes, operations) of ``matches`` Gauss-Newton matches of a scan
    with ``n_valid`` valid points, one evaluation pass each."""
    return (float(matches * (n_valid * BYTES_PER_POINT + BYTES_PER_MATCH)),
            float(matches * (n_valid * OPS_PER_POINT + OPS_PER_MATCH)))


def counted_calls(ctx, pattern: str) -> list:
    """The profiled slice's calls that the Gauss-Newton readers count, as
    (seconds of the kernels matching ``pattern`` in the call, the matches
    it ran, the scan's valid points). The matches are counted from what the
    call ran, never from the kernel: the front-end match where it stepped,
    and ``B`` for each chain batch of ``B`` chains its programs replayed.
    Only calls that replayed programs alone count, and only where the trace
    holds one launch a match group (the front end's, each chain batch's): a
    program without the kernel (its plain loop) gives none."""
    from lib import trace
    from slamref.models.scan import LaserModel, ranges_to_packed

    t, calls = ctx["trace"], ctx["calls"]
    if not t or not calls or len(t["calls"]) != len(calls):
        return []
    laser = LaserModel.from_array(ctx["laser"].to_array())
    out = []
    for call, (secs, count) in zip(calls, trace.kernel_time_by_call(t, pattern)):
        groups = int(call["front"]) + sum(call["chains"].values())
        matches = int(call["front"]) + sum(B * n for B, n in call["chains"].items())
        if not call["replayed_only"] or not groups or count != groups or not secs:
            continue
        n_valid = int(ranges_to_packed(ctx["scans"][call["i"]][0], laser,
                                       ctx["config"].max_points)[2])
        out.append((secs, matches, n_valid))
    return out
