"""The share of the window's steps replayed from a captured program:
``diag.graph_replays`` over ``graph_replays + eager_steps``, summed over
the window's engines (each engine's first call of a program runs eagerly)."""


def read(ctx):
    t = ctx["totals"]
    n = t.get("graph_replays", 0) + t.get("eager_steps", 0)
    return t["graph_replays"] / n if n else None
