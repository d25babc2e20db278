"""The carve kernels' share of their roofline in the profiled slice: the
least time the card could take for the carves the slice's calls made
(``lib/roofline.carve_cost``: the pub map's mark image written once and
the scan read once, over 3.35 TB/s) over the device time of the kernels
whose names match ``PATTERN`` (the mark and its zero fill), in percent.
A carve is one launch of a mark kernel; only calls that replayed programs
alone are counted."""

MARK = r"ray_mark_(beams|tiles)_kernel"
PATTERN = MARK + r"|fill_zero_kernel"


def read(ctx):
    from lib import roofline, trace

    t, calls = ctx["trace"], ctx["calls"]
    if not t or not calls or len(t["calls"]) != len(calls):
        return None
    beams = ctx["config"].max_points
    least = spent = 0.0
    for call, (secs, _), (_, marks) in zip(calls, trace.kernel_time_by_call(t, PATTERN),
                                           trace.kernel_time_by_call(t, MARK)):
        if not call["replayed_only"] or not marks or not secs:
            continue
        b, o = roofline.carve_cost(call["pub_hw"], beams)
        least += roofline.bound_s(marks * b, marks * o, ctx["device_kind"])
        spent += secs
    return 100.0 * least / spent if spent > 0 else None
