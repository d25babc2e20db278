"""Carry state across from the JAX package.

This system has no weights; the front-end state (maps, pose, counters) and
the scan store are what a run carries. The caller fetches the JAX package's
arrays to NumPy and hands them over by name — nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend.processor import FrontendState
from .models.grid_map import CountMap, ProbMap

STATE_KEYS = (
    "pub_hits", "pub_passes", "pub_offset",
    "coarse_probs", "coarse_offset", "fine_probs", "fine_offset",
    "pose", "last_map_update_pose", "map_penalize_times", "scan_index",
    "last_kept_odom",
)
# taken when given (a state the JAX package's pipelined step has run on)
OPTIONAL_STATE_KEYS = ("last_step_time",)


def state_from_jax(arrays: dict[str, np.ndarray], device) -> FrontendState:
    """Build the port's ``FrontendState`` from the JAX ``FrontendState``'s
    leaves, given as NumPy arrays under ``STATE_KEYS`` (``state.pub.hits`` ->
    ``"pub_hits"`` and so on) and, where present, ``OPTIONAL_STATE_KEYS``
    (``last_step_time`` is otherwise the JAX initial state's -3.4e38). Arrays
    are copied to ``device``."""
    missing = [k for k in STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing {missing}")
    f32 = lambda k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
    i32 = lambda k: torch.tensor(int(np.asarray(arrays[k])), dtype=torch.int32,
                                 device=device)
    return FrontendState(
        pub=CountMap(f32("pub_hits"), f32("pub_passes"), f32("pub_offset")),
        coarse=ProbMap(f32("coarse_probs"), f32("coarse_offset")),
        fine=ProbMap(f32("fine_probs"), f32("fine_offset")),
        pose=f32("pose"),
        last_map_update_pose=f32("last_map_update_pose"),
        map_penalize_times=i32("map_penalize_times"),
        scan_index=i32("scan_index"),
        last_kept_odom=f32("last_kept_odom"),
        last_step_time=torch.tensor(np.float32(arrays.get("last_step_time", -3.4e38)),
                                    device=device),
    )


def store_from_jax(arrays: dict[str, np.ndarray], max_points: int, device):
    """Build a ``ScanStore`` from the JAX store's contents: ``points
    (n,P,2)``, ``masks (n,P)``, ``n_valid (n,)``, ``poses (n,3)``, ``odoms
    (n,3)``, ``times (n,)``."""
    from .engine import ScanStore

    store = ScanStore(max_points, device)
    n = len(arrays["times"])
    for i in range(n):
        store.add(arrays["points"][i], arrays["masks"][i],
                  int(arrays["n_valid"][i]), arrays["poses"][i],
                  arrays["odoms"][i], float(arrays["times"][i]))
    return store
