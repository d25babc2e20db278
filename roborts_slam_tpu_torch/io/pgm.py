"""PGM/YAML ground-truth map loading (ROS map_server format).

Own copy of the JAX package's ``io/pgm.py``. Replaces the reference's reliance on ROS map assets (``maps/*.pgm|yaml``):
the same files are the benchmark scenes' ground truth, loaded directly.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import yaml


@dataclasses.dataclass
class GroundTruthMap:
    occupancy: np.ndarray    # (H, W) bool, row 0 = world y-min (origin at [0,0])
    free: np.ndarray         # (H, W) bool known-free
    resolution: float
    origin: np.ndarray       # (2,) world coords of cell (0,0) corner

    @property
    def height(self) -> int:
        return self.occupancy.shape[0]

    @property
    def width(self) -> int:
        return self.occupancy.shape[1]

    def world_extent(self):
        lo = self.origin
        hi = self.origin + np.array([self.width, self.height]) * self.resolution
        return lo, hi


def read_pgm(path: str) -> np.ndarray:
    """Read P5 (binary) or P2 (ascii) PGM into (H, W) uint8/uint16."""
    with open(path, "rb") as f:
        data = f.read()
    # header tokens, skipping comments
    tokens = []
    pos = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if m is None:
            raise ValueError(f"bad pgm header in {path}")
        tok = m.group(1)
        pos += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
        img = np.frombuffer(data, dtype=dtype, count=w * h, offset=pos + 1)
        return img.reshape(h, w)
    if magic == b"P2":
        vals = np.array(data[pos:].split(), dtype=np.int32)[: w * h]
        return vals.reshape(h, w).astype(np.uint8)
    raise ValueError(f"unsupported pgm magic {magic!r}")


def load_ground_truth_map(yaml_path: str) -> GroundTruthMap:
    """Load a map_server YAML + PGM pair (e.g. reference maps/icra.yaml)."""
    import os

    with open(yaml_path) as f:
        meta = yaml.safe_load(f)
    pgm_path = os.path.join(os.path.dirname(yaml_path), meta["image"])
    img = read_pgm(pgm_path).astype(np.float32) / 255.0
    if meta.get("negate", 0):
        occ_prob = img
    else:
        occ_prob = 1.0 - img
    # PGM row 0 is the map's TOP (world y-max); flip so row 0 = y-min
    occ_prob = occ_prob[::-1].copy()
    occupied = occ_prob > float(meta.get("occupied_thresh", 0.65))
    free = occ_prob < float(meta.get("free_thresh", 0.196))
    return GroundTruthMap(
        occupancy=occupied,
        free=free,
        resolution=float(meta["resolution"]),
        origin=np.array(meta.get("origin", [0, 0, 0])[:2], dtype=np.float64),
    )
