"""Host time of the engine's front-end step less its one read (stage
``frontend_step`` less ``frontend_fetch`` of ``engine.timers``, host
clock), summed over the window's engines, per scan fed."""


def read(ctx):
    t = ctx["totals"]
    if not ctx["fed"] or not t.get("frontend_step_s"):
        return None
    return 1e3 * (t["frontend_step_s"] - t["frontend_fetch_s"]) / ctx["fed"]
