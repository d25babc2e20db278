"""The corridor-loop log, made from a seed: the benchmark's one traffic
generator.

A traffic mix (``<name>.json`` beside this file) gives the world, the path,
the lidar, the speed and the odometry error; ``make_log`` turns it and a
seed into the scans a replay feeds. The world and the path are copies of the
program's parity harness (``bench/parity.py``: a 24 m x 16 m hall round an
18 m x 10 m block, a 3 m corridor textured every 2 m, 0.05 m cells; the
corridor's centre line, 66.3 m a lap), the odometry model a copy of its
simulator's (``io/simulate.py``: a bounded systematic bias per run and
per-step noise, both scaled by the error). The rays are marched on the
device in chunks of scans, by the simulator's rule: half-cell steps from the
pose, the first occupied cell or the first step off the map ends a beam, no
hit reads the range limit. Everything is float64 and uses the same
operations in the same order as the NumPy march, so the two give the same
ranges bit for bit; range noise is then drawn on the device from the seed.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Laser:
    """The lidar (the program's ``LaserModel`` fields, in its order)."""

    angle_min: float
    angle_max: float
    range_min: float
    range_max: float
    num_beams: int
    range_threshold_scale: float
    scan_time: float

    def to_array(self) -> np.ndarray:
        return np.array([self.angle_min, self.angle_max, self.range_min, self.range_max,
                         self.num_beams, self.range_threshold_scale, self.scan_time])

    @property
    def angles(self) -> np.ndarray:
        return np.linspace(self.angle_min, self.angle_max, self.num_beams)


@dataclasses.dataclass
class Log:
    ranges: np.ndarray      # (N, beams) float32
    odom: np.ndarray        # (N, 3) float64
    times: np.ndarray       # (N,) float64
    gt: np.ndarray          # (N, 3) true poses
    laser: Laser


def load_mix(name: str) -> dict:
    """The traffic mix ``name`` (``<name>.json`` in this folder)."""
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


# ---- the world and the path (copies of bench/parity.py) ----

def corridor_world(res: float = 0.05):
    """(occupancy (H, W) bool, resolution, origin (2,)): a closed corridor
    3 m wide round a solid 18 m x 10 m block inside a 24 m x 16 m hall, with
    door recesses (0.8 m wide, 0.5 m deep) in the outer wall and buttresses
    (0.5 m wide, 0.3 m deep) on the block every 2 m."""
    x0, y0 = -1.0, -1.0
    occ = np.ones((int(18 / res), int(26 / res)), bool)

    def box(xa, xb, ya, yb, value):
        occ[int(round((ya - y0) / res)):int(round((yb - y0) / res)),
            int(round((xa - x0) / res)):int(round((xb - x0) / res))] = value

    box(0, 24, 0, 16, False)
    box(3, 21, 3, 13, True)
    for x in np.arange(1.0, 23.0, 2.0):
        box(x, x + 0.8, -0.5, 0, False)
        box(x + 1, x + 1.8, 16, 16.5, False)
    for y in np.arange(1.0, 15.0, 2.0):
        box(-0.5, 0, y, y + 0.8, False)
        box(24, 24.5, y + 1, y + 1.8, False)
    for x in np.arange(4.0, 20.0, 2.0):
        box(x, x + 0.5, 2.7, 3, True)
        box(x + 1, x + 1.5, 13, 13.3, True)
    for y in np.arange(4.0, 12.0, 2.0):
        box(2.7, 3, y, y + 0.5, True)
        box(21, 21.3, y + 1, y + 1.5, True)
    return occ, res, np.array([x0, y0])


def corridor_path(laps: float) -> np.ndarray:
    """The corridor's centre line (a 21 m x 13 m rectangle, corners rounded
    at 1 m, 66.3 m round), anticlockwise from the middle of the bottom
    corridor, as a polyline of 2 cm steps over ``laps`` laps."""
    r, ds = 1.0, 0.02
    xa, xb, ya, yb = 1.5, 22.5, 1.5, 14.5
    pts = []

    def line(p, q):
        n = max(int(np.hypot(q[0] - p[0], q[1] - p[1]) / ds), 1)
        pts.extend(np.linspace(p, q, n, endpoint=False))

    def arc(c, a0):
        n = int(r * np.pi / 2 / ds)
        a = a0 + np.linspace(0, np.pi / 2, n, endpoint=False)
        pts.extend(np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], -1))

    line((12.0, ya), (xb - r, ya))
    arc((xb - r, ya + r), -np.pi / 2)
    line((xb, ya + r), (xb, yb - r))
    arc((xb - r, yb - r), 0.0)
    line((xb - r, yb), (xa + r, yb))
    arc((xa + r, yb - r), np.pi / 2)
    line((xa, yb - r), (xa, ya + r))
    arc((xa + r, ya + r), np.pi)
    line((xa + r, ya), (12.0, ya))
    lap = np.asarray(pts)
    whole, part = int(laps), laps - int(laps)
    return np.concatenate([lap] * whole + [lap[:int(len(lap) * part) + 1]])


def path_to_trajectory(path: np.ndarray, speed: float, scan_rate: float) -> np.ndarray:
    """The polyline resampled at constant speed, heading along its tangent
    (smoothed): (N, 4) x, y, theta, t."""
    seg_len = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0], np.cumsum(seg_len)])
    total = s[-1]
    dt = 1.0 / scan_rate
    n = max(int(total / speed / dt), 2)
    ts = np.arange(n) * dt
    ss = np.minimum(ts * speed, total - 1e-9)
    x = np.interp(ss, s, path[:, 0])
    y = np.interp(ss, s, path[:, 1])
    th = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    if n > 10:
        k = 9
        pad = np.pad(th, (k // 2, k // 2), mode="edge")
        th = np.convolve(pad, np.ones(k) / k, mode="valid")
    return np.stack([x, y, th, ts], -1)


def odometry(gt: np.ndarray, rng: np.random.Generator, error) -> np.ndarray:
    """Odometry integrated from the true body-frame deltas, each scaled by
    ``1 + bias + noise``: the bias drawn once in ``[-1, 1] * error``, the
    noise per step from N(0, 0.3 * error)."""
    err = np.asarray(error, np.float64)
    bias = rng.uniform(-1, 1, 3) * err
    noise = rng.normal(0, 0.3, (len(gt), 3)) * err
    odom = np.zeros((len(gt), 3))
    cur = np.zeros(3)
    for i in range(1, len(gt)):
        d = gt[i] - gt[i - 1]
        c, s = np.cos(gt[i - 1, 2]), np.sin(gt[i - 1, 2])
        body = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])
        body = body * (1.0 + bias + noise[i])
        c2, s2 = np.cos(cur[2]), np.sin(cur[2])
        cur = np.array([cur[0] + c2 * body[0] - s2 * body[1],
                        cur[1] + s2 * body[0] + c2 * body[1], cur[2] + body[2]])
        odom[i] = cur
    return odom


# ---- the rays ----

def march(occupancy, resolution: float, origin, poses, angles, range_max: float,
          device, chunk: int = 32) -> torch.Tensor:
    """(N, B) float64 ranges of every beam of every pose, marched in
    half-cell steps: the first step whose cell is occupied or off the map
    ends the beam, at that step's distance; no such step reads
    ``range_max``. ``poses`` (N, 3), ``angles`` (B,) in the sensor frame."""
    occ = torch.as_tensor(np.asarray(occupancy, bool), device=device)
    H, W = occ.shape
    step = resolution * 0.5
    n_steps = int(np.ceil(range_max / step)) + 1
    ts = torch.arange(1, n_steps + 1, dtype=torch.float64, device=device) * step
    org = torch.as_tensor(np.asarray(origin, np.float64), device=device)
    out = []
    for c0 in range(0, len(poses), chunk):
        p = np.asarray(poses[c0:c0 + chunk], np.float64)
        a = angles[None, :] + p[:, 2:3]
        dirs = torch.as_tensor(np.stack([np.cos(a), np.sin(a)], -1), device=device)
        pos = torch.as_tensor(p[:, :2], device=device)
        pts = pos[:, None, None, :] + dirs[:, :, None, :] * ts[None, None, :, None]
        cells = torch.floor((pts - org) / resolution).to(torch.int64)
        cx, cy = cells[..., 0], cells[..., 1]
        outside = (cx < 0) | (cx >= W) | (cy < 0) | (cy >= H)
        hit = occ[cy.clamp(0, H - 1), cx.clamp(0, W - 1)] | outside
        first = torch.argmax(hit.to(torch.uint8), dim=-1)
        any_hit = torch.gather(hit, -1, first[..., None])[..., 0]
        out.append(torch.where(any_hit, ts[first], torch.full_like(ts[first], range_max)))
    return torch.cat(out)


def make_log(mix: dict, seed: int, device) -> Log:
    """The log of traffic mix ``mix`` from ``seed``: the path driven
    ``laps`` times round at ``speed`` m/s, one scan every 1/``scan_rate``
    s, odometry from ``odom_error``, ranges marched on ``device`` with
    N(0, ``range_noise``) noise, clipped to [0, range_max]."""
    if mix.get("world") != "corridor_loop":
        raise ValueError(f"unknown world {mix.get('world')!r}")
    laser = Laser(**mix["laser"])
    traj = path_to_trajectory(corridor_path(mix["laps"]), mix["speed"], mix["scan_rate"])
    gt, times = traj[:, :3], traj[:, 3]
    rng = np.random.default_rng(seed)
    odom = odometry(gt, rng, mix["odom_error"])
    occ, res, origin = corridor_world(mix["cell"])
    ranges = march(occ, res, origin, gt, laser.angles, laser.range_max, device).to(torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    noise = torch.randn(ranges.shape, generator=gen, device=device, dtype=torch.float32)
    ranges = torch.clamp(ranges + noise * float(mix["range_noise"]), 0.0, laser.range_max)
    return Log(ranges=ranges.cpu().numpy(), odom=odom, times=times, gt=gt, laser=laser)
