"""The headline benchmark's workload.

One definition of the synthetic 3-tier match workload (2048² hash-pattern
fine map at 0.01 m, a willow-beam sinusoid scan), the counterpart of the JAX
package's ``bench/workload.py``. The map content is the pseudo-random hash
pattern that ``native/baseline_correlative.cpp`` also generates, so the card
and the CPU baseline score the same content in default mode.

The tiers are the ones the CPU baseline hard-codes
(``native/baseline_correlative.cpp:41-45``, from the reference's simulation
profile), set on ``configs/simulation.yaml``, whose own tiers differ: card
and baseline then score the same candidates.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "simulation.yaml"
MAP_SIZE = 2048               # fine map cells a side (0.01 m: 20.48 m)

# The three tiers of the CPU baseline: search-space size (m), its resolution
# (m), angle offset (rad), angle resolution (rad), points used.
BASELINE_TIERS = {
    "coarse": (0.6, 0.05, 0.523, 0.0349, 100),
    "fine": (0.2, 0.02, 0.175, 0.0349, 100),
    "super_fine": (0.02, 0.01, 0.0349, 0.00349, 100),
}
_TIER_KEYS = ("search_space_size", "search_space_resolution",
              "search_angle_offset", "search_angle_resolution", "use_point_size")
# the same as config overrides (``load_config(CONFIG, **TIER_OVERRIDES)``)
TIER_OVERRIDES = {f"{tier}_{key}": value
                  for tier, values in BASELINE_TIERS.items()
                  for key, value in zip(_TIER_KEYS, values)}


def hash_map(height: int = MAP_SIZE, width: int = MAP_SIZE) -> np.ndarray:
    """The baseline's map content: cell ``i`` (row-major) holds
    ``(i * 2654435761 & 0xFFFF) / 65535``, as float32."""
    idx = np.arange(height * width, dtype=np.uint64)
    return (((idx * 2654435761) & 0xFFFF) / 65535.0).astype(np.float32).reshape(
        height, width)


def headline_workload(beams: int = 1081, device=None) -> dict:
    """Everything a 3-tier ``scan_match`` call needs, as the JAX function
    returns it (the same keys): matcher params, fine/coarse specs, prob
    planes and offsets, the packed scan (points, mask, ``n_valid``) and the
    init pose, as tensors on ``device`` (``None``: the card; raises without
    one). ``n_valid`` is a Python ``int``, as the port's matchers take it."""
    from ..config import load_config
    from ..engine import resolve_device
    from ..frontend.matchers import MatcherParams
    from ..models.grid_map import ProbMapSpec

    dev = resolve_device(device)
    cfg = load_config(str(CONFIG), **TIER_OVERRIDES)
    matcher = MatcherParams.from_config(cfg, use_center_penalty=True)
    H = W = MAP_SIZE
    fine_spec = ProbMapSpec(resolution=0.01, height=H, width=W,
                            deviation=cfg.fine_map_deviation,
                            blur_offset=cfg.gaussian_blur_offset)
    coarse_spec = ProbMapSpec(resolution=0.08, height=256, width=256,
                              deviation=cfg.coarse_map_deviation,
                              blur_offset=cfg.gaussian_blur_offset)

    ang = np.linspace(-2.35, 2.35, beams)
    r = 3.0 + 2.0 * np.sin(5 * ang)
    P = cfg.max_points
    points = np.zeros((P, 2), np.float32)
    points[:beams, 0] = r * np.cos(ang)
    points[:beams, 1] = r * np.sin(ang)
    mask = np.zeros(P, bool)
    mask[:beams] = True
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "cfg": cfg, "matcher": matcher,
        "fine_spec": fine_spec, "coarse_spec": coarse_spec,
        "fine_probs": torch.as_tensor(hash_map(H, W), device=dev),
        "coarse_probs": torch.full((256, 256), 0.3, **f32),
        "offset": torch.tensor([10.24, 10.24], **f32),
        "coff": torch.tensor([10.24, 10.24], **f32),
        "points": torch.as_tensor(points, device=dev),
        "mask": torch.as_tensor(mask, device=dev),
        "n_valid": int(beams),
        "init_pose": torch.tensor([0.01, 0.0, 0.0], **f32),
    }
