"""Carry state across from the JAX package.

This system has no weights; the front-end state (maps, pose, counters), the
scan store, a pose graph's solver data and a log-odds map are what a run
carries. The caller fetches the JAX package's arrays to NumPy and hands them
over by name — nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend.spa import PoseGraphData
from .frontend.processor import FrontendState
from .models.grid_map import CountMap, LogOddsMap, ProbMap

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


def pose_graph_from_jax(arrays: dict[str, np.ndarray], device) -> PoseGraphData:
    """The port's ``PoseGraphData`` from the JAX ``PoseGraphData``'s fields
    as NumPy arrays by name (``poses``, ``node_mask``, ``edge_ij``,
    ``edge_rel``, ``edge_info``, ``edge_mask``), padding included, on
    ``device``. Edge ids become int64 (the port's index type)."""
    missing = [k for k in PoseGraphData._fields if k not in arrays]
    if missing:
        raise KeyError(f"pose_graph_from_jax: missing {missing}")
    t = lambda k, dt: torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)
    return PoseGraphData(
        poses=t("poses", torch.float32), node_mask=t("node_mask", torch.bool),
        edge_ij=t("edge_ij", torch.int64), edge_rel=t("edge_rel", torch.float32),
        edge_info=t("edge_info", torch.float32), edge_mask=t("edge_mask", torch.bool))


def log_odds_map_from_jax(arrays: dict[str, np.ndarray], device) -> LogOddsMap:
    """The port's ``LogOddsMap`` from the JAX one's ``log_odds`` (H, W) and
    ``offset`` (2,), as NumPy arrays, on ``device``."""
    return LogOddsMap(
        log_odds=torch.tensor(np.asarray(arrays["log_odds"], np.float32), device=device),
        offset=torch.tensor(np.asarray(arrays["offset"], np.float32), device=device))
