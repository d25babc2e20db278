"""Host time of the odometry de-distortion on ingest
(``diag.dedistort_time_s``), summed over the window's engines, per scan
fed; nothing where no scan was de-distorted."""


def read(ctx):
    t = ctx["totals"]
    if not ctx["fed"] or not t.get("scans_dedistorted"):
        return None
    return 1e3 * t["dedistort_s"] / ctx["fed"]
