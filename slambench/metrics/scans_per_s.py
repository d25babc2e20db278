"""Scans fed in the window over the window's seconds (host clock): every
``process()`` call of every episode, the engines' construction and
``finish()`` included."""


def read(ctx):
    return ctx["fed"] / ctx["window_s"] if ctx["window_s"] > 0 and ctx["fed"] else None
