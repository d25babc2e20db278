"""Benchmark scene presets — the reference's three stage worlds.

Own copy of the JAX package's ``io/scenes.py``. The map files are not part
of this repository: they are the reference's ``maps/*.pgm|yaml``, looked for
in ``REFERENCE_MAPS_DIR``, the directory ``maps`` under the working directory.

Laser models and odometry noise read off the world files:
- willow: 1081 beams, 270.25°, 10 m (worlds/willow-pr2-5cm.world:8-17),
  odom_error [0.02 0.02 0 0.02] (:25)
- icra:   270 beams, 270°, 8 m (worlds/icra.world:18-28),
  odom_error [0.03 0.03 0 0.05] (:38)
- rm:     270 beams, 270°, 30 m (worlds/rm.world:18-28)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..models.scan import LaserModel
from .pgm import GroundTruthMap, load_ground_truth_map

REFERENCE_MAPS_DIR = "maps"


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    map_yaml: str
    laser: LaserModel
    odom_error: tuple
    speed: float = 0.5
    n_waypoints: int = 6
    clearance_m: float = 0.3


def _deg(d):
    return d * np.pi / 180.0


SCENES = {
    "icra": Scene(
        name="icra",
        map_yaml=os.path.join(REFERENCE_MAPS_DIR, "icra.yaml"),
        laser=LaserModel(angle_min=-_deg(135), angle_max=_deg(135),
                         range_min=0.05, range_max=8.0, num_beams=270),
        odom_error=(0.03, 0.03, 0.05),
        n_waypoints=6, clearance_m=0.3,
    ),
    "rm": Scene(
        name="rm",
        map_yaml=os.path.join(REFERENCE_MAPS_DIR, "rm.yaml"),
        laser=LaserModel(angle_min=-_deg(135), angle_max=_deg(135),
                         range_min=0.05, range_max=30.0, num_beams=270),
        odom_error=(0.03, 0.03, 0.05),
        n_waypoints=6, clearance_m=0.3,
    ),
    "willow": Scene(
        name="willow",
        map_yaml=os.path.join(REFERENCE_MAPS_DIR, "willow-full-0.05.yaml"),
        laser=LaserModel(angle_min=-_deg(135.125), angle_max=_deg(135.125),
                         range_min=0.05, range_max=10.0, num_beams=1081),
        odom_error=(0.02, 0.02, 0.02),
        n_waypoints=8, clearance_m=0.3,
    ),
}


def load_scene_map(scene: Scene) -> GroundTruthMap:
    return load_ground_truth_map(scene.map_yaml)
