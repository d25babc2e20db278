"""The Gauss-Newton match kernel's share of its roofline in the profiled
slice: the least time the card could take for the matches the slice's calls
ran (``lib/gn_cost.py``: one evaluation pass over the scan's valid points a
match; bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever is
larger, ``lib/roofline.bound_s``) over the device time of the kernels whose
names match ``PATTERN``, in percent. The calls and their matches are
``gn_cost.counted_calls``'s: replayed programs alone, one launch a match
group; a program that runs the plain loop gives no value."""

PATTERN = r"gauss_newton_match_kernel"


def read(ctx):
    from lib import gn_cost, roofline

    least = spent = 0.0
    for secs, matches, n_valid in gn_cost.counted_calls(ctx, PATTERN):
        least += roofline.bound_s(*gn_cost.match_cost(n_valid, matches), ctx["device_kind"])
        spent += secs
    return 100.0 * least / spent if spent > 0 else None
