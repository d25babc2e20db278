"""1 - the union of the device's activity intervals (kernels, copies,
sets) over the length of the profiled slice, from the traced run's one
``torch.profiler`` trace."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
