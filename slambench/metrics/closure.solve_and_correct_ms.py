"""Host time of a pose-graph solve and its corrections
(``backend.solve_time_s`` over ``backend.num_solves``, summed over the
window's engines; the solve's one read and the map rebuild included)."""


def read(ctx):
    t = ctx["totals"]
    return 1e3 * t["solve_time_s"] / t["num_solves"] if t.get("num_solves") else None
