"""The mean ``process()`` time of the window's calls that applied a loop
closure (the engine's closure count rose): what a blocking replay stalls
for a closure, solve, corrections and map rebuild included."""


def read(ctx):
    d = ctx["closure_durations"]
    return 1e3 * sum(d) / len(d) if d else None
