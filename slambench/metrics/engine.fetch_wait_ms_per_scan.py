"""The step's one read (stage ``frontend_fetch``: the host waiting on the
device), summed over the window's engines, per scan fed."""


def read(ctx):
    t = ctx["totals"]
    if not ctx["fed"] or not t.get("frontend_fetch_s"):
        return None
    return 1e3 * t["frontend_fetch_s"] / ctx["fed"]
