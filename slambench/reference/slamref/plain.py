"""What the copied modules took from the kernel package, in plain form.

The copies under ``slamref`` are frozen copies of the engine's plain paths.
Where the engine calls a hand-written kernel, the copy calls the plain
PyTorch version beside it; nothing here launches a kernel. ``LOWER``
switches the reference to the precision below float32 for the control of
the correctness check: the correlation sums and the match maps in bfloat16,
the pose-graph solve in bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

LOWER = {"on": False}


def lower() -> bool:
    return LOWER["on"]


def round_lower(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 where the lower precision is on."""
    return t.to(torch.bfloat16).to(t.dtype) if lower() and t.is_floating_point() else t


@contextlib.contextmanager
def lower_precision(on: bool = True):
    old = LOWER["on"]
    LOWER["on"] = on
    try:
        yield
    finally:
        LOWER["on"] = old


def scores_fn():
    from .ops.correlative import correlation_scores_plain

    return correlation_scores_plain


def ray_mark_image(start, end, beam_mask, height: int, width: int):
    from .ops.raster import mark_image_plain

    return mark_image_plain(start, end, beam_mask, height, width)


def bad_ray_count(start, end, ray_ok, hits, passes, min_passthrough: float,
                  occu_threshold: float, thr_d2: int):
    from .ops.raycast import bad_rays_plain

    return bad_rays_plain(start, end, ray_ok, hits, passes, min_passthrough,
                          occu_threshold, thr_d2)
