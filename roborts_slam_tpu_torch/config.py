"""Configuration schema of the PyTorch/CUDA SLAM engine.

The package's own copy of the JAX package's ``config.py`` (the two packages
share no module): the same fields, defaults and YAML loading, mirroring the
reference parameter surface 1:1 (``src/param_config.h:27-122``) so the
reference's YAML profiles load unchanged. A frozen dataclass: hashable and
immutable, passed to plain functions as static configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import yaml


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """All SLAM engine parameters (defaults match ``param_config.h``)."""

    # -- frames / topics (kept for config-file compatibility; unused offline) --
    odom_frame_id: str = "odom"
    base_frame_id: str = "base_link"
    laser_frame_id: str = ""
    global_frame_id: str = "odom"
    odom_topic_name: str = "odom"
    map_topic_name: str = "map"
    laser_topic_name: str = "scan"
    publish_visualize: bool = True

    # -- sensor preprocessing (param_config.h:36-38) --
    use_odom_correct: bool = False
    odom_interpolation_time: float = 0.005
    range_threshold_scale: float = 0.95

    # -- map geometry (param_config.h:41-45) --
    init_map_size: float = 5.0
    map_offset_x: float = 0.5
    map_offset_y: float = 0.5
    bound_tolerance: float = 1.0
    map_extend_factor: float = 0.03

    # -- pub (occupancy-count) map (param_config.h:47-51) --
    map_resolution: float = 0.05
    map_update_free_factor: float = 0.3
    map_update_occu_factor: float = 0.7
    map_occu_threshold: float = 0.2
    map_min_passthrough: float = 3.0

    # -- scan-match map pyramid (param_config.h:53-61) --
    coarse_map_resolution: float = 0.1
    coarse_map_deviation: float = 0.4
    coarse_map_use_blur: bool = True
    fine_map_resolution: float = 0.01
    fine_map_deviation: float = 0.03
    fine_map_use_blur: bool = True
    gaussian_blur_offset: float = 0.72

    # -- Gauss-Newton (optimize) matcher (param_config.h:63-69) --
    use_optimize_scan_match: bool = True
    iterate_times: int = 10
    cost_decrease_threshold: float = 1.0
    cost_min_threshold: float = 2.0
    max_update_distance: float = 0.5
    max_update_angle: float = 0.2
    optimize_failed_cost: float = 20.0

    # -- fast (branch-and-bound) correlative match --
    # The reference wires a BnB matcher but its call site is disabled
    # (FAST_CORRELATION_SCAN_MATCH, scan_matchers.h:266-273, params
    # hard-coded :337-344). Here it is selectable: it replaces the coarse
    # correlative stage with a beam search over max-pooled score bounds
    # (ops/branch_and_bound.py). Defaults mirror the reference block.
    use_fast_correlation_match: bool = False
    fast_match_space_size: float = 0.8
    fast_match_space_resolution: float = 0.01
    fast_match_angle_offset: float = 0.523
    fast_match_angle_resolution: float = 0.00349
    fast_match_response_threshold: float = 0.5
    fast_match_use_point_size: int = 100
    fast_match_max_depth: int = 4
    fast_match_beam_width: int = 256

    # -- correlative search tiers (param_config.h:71-90) --
    coarse_search_space_size: float = 0.8
    coarse_search_space_resolution: float = 0.1
    coarse_search_angle_offset: float = 0.01745 * 100
    coarse_search_angle_resolution: float = 0.01745 * 2
    coarse_response_threshold: float = 0.6
    coarse_use_point_size: int = 100

    fine_search_space_size: float = 0.2
    fine_search_space_resolution: float = 0.02
    fine_search_angle_offset: float = 0.01745 * 20
    fine_search_angle_resolution: float = 0.01745 * 2
    fine_response_threshold: float = 0.7
    fine_use_point_size: int = 100

    super_fine_search_space_size: float = 0.02
    super_fine_search_space_resolution: float = 0.01
    super_fine_search_angle_offset: float = 0.01745 * 2
    super_fine_search_angle_resolution: float = 0.01745 * 0.2
    super_fine_response_threshold: float = 0.7
    super_fine_use_point_size: int = 200

    # -- odometry / gates (param_config.h:92-110) --
    use_odometry: bool = True
    use_map_check_feedback: bool = True
    map_check_point_num: int = 50
    map_check_bound_tolerance: float = 3.0
    map_check_penalty_gain: float = 0.05

    use_map_update_move_check: bool = False
    map_update_score_threshold: float = 0.48
    map_update_distance_threshold: float = 0.1
    map_update_angle_threshold: float = 0.01745 * 1

    use_move_check: bool = False
    move_distance_threshold: float = 0.05
    move_angle_threshold: float = 0.01745 * 0.5
    move_time_threshold: float = 5.0

    move_max_linear_vel: float = 3.0
    move_max_angular_vel: float = 3.0

    running_range_max_distance: float = 5.0
    running_range_size: int = 70
    # windowed front-end matching: match each scan against maps rebuilt from
    # the running-range window instead of the accumulated match maps. The
    # reference defines this path but ships it disabled
    # (kUseRunningRangeScanMatch = false, slam_processor.h:265,
    # slam_processor.cpp:134-159); here it is a live config option.
    use_running_range_scan_match: bool = False

    # -- pose graph / loop closure (param_config.h:115-120) --
    loop_match_min_chain_size: int = 8
    link_match_min_response: float = 0.8
    link_scan_max_distance: float = 7.0
    loop_match_min_response_coarse: float = 0.58
    loop_match_max_variance_coarse: float = 0.4
    loop_match_min_response_fine: float = 0.55

    # ------------------------------------------------------------------
    # Build knobs without a reference equivalent: they fix array shapes
    # (padded beam count, chain length, preallocated world extent).
    # ------------------------------------------------------------------
    max_points: int = 1152           # padded beam count per scan (>= 1081 willow)
    max_chain_scans: int = 16        # padded scans per back-end chain map
    world_size: float = 0.0          # preallocated world extent (m); 0 = derive
    # scan-match map window (m); 0 = size to the world like the reference.
    # >0 keeps fine/coarse match maps as a fixed window recentered to follow
    # the robot (removes the fixed-world matching limit; pub map stays global)
    match_map_window: float = 0.0
    compute_dtype: str = "float32"

    def derived_world_size(self, range_max: float) -> float:
        """Initial world extent, reference ``CreateAllMap`` sizing rule
        (slam_processor.cpp:468-470): ``init_map_size * range_max`` with a
        floor of ``kMinMapSize(=3) * range_max``."""
        if self.world_size > 0:
            return self.world_size
        k_min_map_size = 3.0
        factor = self.init_map_size if self.init_map_size >= k_min_map_size else k_min_map_size
        return factor * range_max

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def _coerce(value, field_type):
    if field_type is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes")
        return bool(value)
    if field_type is int:
        return int(value)
    if field_type is float:
        return float(value)
    return value


def load_config(yaml_path: Optional[str] = None, **overrides) -> SlamConfig:
    """Build a :class:`SlamConfig`, optionally from a reference-format YAML.

    Unknown YAML keys are ignored (the reference tolerates extra ROS params
    the same way); known keys are type-coerced to the dataclass field types.
    """
    values = {}
    if yaml_path is not None:
        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name: f.type for f in dataclasses.fields(SlamConfig)}
        for key, val in raw.items():
            if key in fields and val is not None:
                ftype = SlamConfig.__dataclass_fields__[key].type
                # dataclass stores type annotations as strings under
                # `from __future__ import annotations`
                tmap = {"bool": bool, "int": int, "float": float, "str": str}
                values[key] = _coerce(val, tmap.get(str(ftype), str))
    values.update(overrides)
    return SlamConfig(**values)


def gaussian_kernel_half_size(sigma: float, resolution: float) -> int:
    """Blur kernel half width, reference ``GaussianBlur::CalculateKernelSize``
    (occu_grid_map.h:101-105): ``int((sigma/res) * sqrt(ln 2))``; 0 disables
    blur when sigma is outside (0.5*res, 10*res) (occu_grid_map.h:44-58)."""
    if not (0.5 * resolution < sigma < 10.0 * resolution) or resolution <= 0:
        return 0
    return int((sigma / resolution) * math.sqrt(math.log(2.0)))
