"""The correlation kernels' share of their roofline in the profiled slice:
the least time the card could take for the tier matches the slice's calls
ran (``lib/roofline.py``: bytes over 3.35 TB/s or operations over 67
TFLOP/s, whichever is larger) over the device time of the kernels whose
names match ``PATTERN``, in percent.

The matches are counted from what each call ran, never from the kernels:
three tiers of the front-end step where the call stepped, and three tiers
over the ``B`` maps of each chain batch its programs replayed. Only calls
that replayed programs alone are counted (an eager first call or a capture
runs the plain parts in another order), and only where the trace holds one
launch a tier."""

import dataclasses

PATTERN = r"correlation_scores(_v2)?_kernel"


def read(ctx):
    import torch
    from lib import roofline, trace
    from slamref.config import SlamConfig
    from slamref.backend.processor import BackendSpec
    from slamref.frontend.matchers import MatcherParams
    from slamref.frontend.processor import FrontendSpec
    from slamref.models.scan import LaserModel, ranges_to_packed
    from slamref.ops.correlative import valid_count

    t, calls = ctx["trace"], ctx["calls"]
    if not t or not calls or len(t["calls"]) != len(calls):
        return None
    cfg = SlamConfig(**dataclasses.asdict(ctx["config"]))
    laser = LaserModel.from_array(ctx["laser"].to_array())
    world = ctx["world_size"] if ctx["world_size"] is not None else cfg.derived_world_size(laser.range_max)
    fs = FrontendSpec.from_config(cfg, laser.range_max, world)
    chain = BackendSpec.from_config(cfg, laser.range_max, fs.pub_spec).fine_spec
    matcher = MatcherParams.from_config(cfg)
    dev = ctx["device"]
    least = spent = 0.0
    for call, (secs, count) in zip(calls, trace.kernel_time_by_call(t, PATTERN)):
        matches = int(call["front"]) + sum(call["chains"].values())
        if not call["replayed_only"] or call["pose"] is None or count != 3 * matches or not secs:
            continue
        pts, _, n_valid = ranges_to_packed(ctx["scans"][call["i"]][0], laser, cfg.max_points)
        pts = torch.as_tensor(pts, device=dev)
        nv = valid_count(n_valid, dev)
        pose = torch.as_tensor(call["pose"], dtype=torch.float32, device=dev)
        nb = no = 0.0
        if call["front"]:
            b, o = roofline.match_cost(fs.fine_spec, matcher, pts, nv, pose,
                                       torch.as_tensor(call["fine_offset"], dtype=torch.float32,
                                                       device=dev),
                                       (fs.fine_spec.height, fs.fine_spec.width))
            nb, no = nb + b, no + o
        size = torch.tensor([chain.width * chain.resolution, chain.height * chain.resolution],
                            device=dev)
        off = -(pose[:2] - 0.5 * size)
        for B, n in call["chains"].items():
            b, o = roofline.match_cost(chain, matcher, pts, nv, pose, off,
                                       (chain.height, chain.width), batch=B)
            nb, no = nb + n * b, no + n * o
        least += roofline.bound_s(nb, no, ctx["device_kind"])
        spent += secs
    return 100.0 * least / spent if spent > 0 else None
