"""LiDAR simulator over ground-truth maps (NumPy/SciPy only).

Own copy of the JAX package's ``io/simulate.py``. Replaces the reference's stage-based integration tests
(launch/roborts_slam_stage_*.launch + worlds/*.world): the same GT maps
(maps/*.pgm) are ray-cast directly to produce scan logs with odometry noise
(worlds/icra.world:38 ``odom_error [0.03 0.03 0.00 0.05]``), yielding
ground-truth trajectories for ATE benchmarking — something the stage setup
only had in commented-out form (roborts_slam_stage_willow.launch:11-14).
"""

from __future__ import annotations

import heapq

import numpy as np

from ..models.scan import LaserModel
from .pgm import GroundTruthMap
from .scan_log import ScanLog


def raycast(gt: GroundTruthMap, pose: np.ndarray, laser: LaserModel,
            rng: np.random.Generator | None = None,
            range_noise: float = 0.0) -> np.ndarray:
    """Cast all beams from ``pose``; returns (B,) ranges (range_max if no hit).

    Vectorized DDA: march every beam simultaneously in half-cell steps and
    take the first occupied cell per beam.
    """
    res = gt.resolution
    step = res * 0.5
    n_steps = int(np.ceil(laser.range_max / step)) + 1
    angles = laser.angles + pose[2]
    dirs = np.stack([np.cos(angles), np.sin(angles)], -1)          # (B,2)
    ts = (np.arange(1, n_steps + 1) * step)                        # (S,)
    pts = pose[None, None, :2] + dirs[:, None, :] * ts[None, :, None]  # (B,S,2)
    cells = np.floor((pts - gt.origin[None, None, :]) / res).astype(np.int64)
    cx = np.clip(cells[..., 0], 0, gt.width - 1)
    cy = np.clip(cells[..., 1], 0, gt.height - 1)
    outside = (
        (cells[..., 0] < 0) | (cells[..., 0] >= gt.width)
        | (cells[..., 1] < 0) | (cells[..., 1] >= gt.height)
    )
    hit = gt.occupancy[cy, cx] | outside
    first = np.argmax(hit, axis=1)                                  # (B,)
    any_hit = hit[np.arange(hit.shape[0]), first]
    ranges = np.where(any_hit, ts[first], laser.range_max).astype(np.float32)
    if range_noise > 0 and rng is not None:
        ranges = ranges + rng.normal(0, range_noise, ranges.shape).astype(np.float32)
    return np.clip(ranges, 0.0, laser.range_max)


def _erode_free(gt: GroundTruthMap, radius_m: float) -> np.ndarray:
    """Free cells with >= radius clearance (cheap box erosion)."""
    r = max(int(np.ceil(radius_m / gt.resolution)), 1)
    blocked = gt.occupancy | ~gt.free
    acc = blocked.copy()
    for dy in range(-r, r + 1):
        shifted = np.roll(blocked, dy, axis=0)
        if dy > 0:
            shifted[:dy] = True
        elif dy < 0:
            shifted[dy:] = True
        acc |= shifted
    acc2 = acc.copy()
    for dx in range(-r, r + 1):
        shifted = np.roll(acc, dx, axis=1)
        if dx > 0:
            shifted[:, :dx] = True
        elif dx < 0:
            shifted[:, dx:] = True
        acc2 |= shifted
    return ~acc2


def _largest_component(free: np.ndarray) -> np.ndarray:
    """Keep only the largest 8-connected free component (arenas like rm have
    disjoint free regions; a loop path must stay within one)."""
    from scipy import ndimage

    labels, n = ndimage.label(free, structure=np.ones((3, 3), dtype=int))
    if n <= 1:
        return free
    sizes = ndimage.sum(free, labels, index=np.arange(1, n + 1))
    keep = 1 + int(np.argmax(sizes))
    return labels == keep


def _astar(free: np.ndarray, start: tuple, goal: tuple) -> list | None:
    """8-connected A* on the free grid; start/goal are (y, x)."""
    H, W = free.shape
    if not free[start] or not free[goal]:
        return None
    nbrs = [(-1, -1, 1.414), (-1, 0, 1.0), (-1, 1, 1.414), (0, -1, 1.0),
            (0, 1, 1.0), (1, -1, 1.414), (1, 0, 1.0), (1, 1, 1.414)]
    g = {start: 0.0}
    came = {}
    h0 = np.hypot(goal[0] - start[0], goal[1] - start[1])
    pq = [(h0, start)]
    closed = set()
    while pq:
        _, cur = heapq.heappop(pq)
        if cur == goal:
            path = [cur]
            while cur in came:
                cur = came[cur]
                path.append(cur)
            return path[::-1]
        if cur in closed:
            continue
        closed.add(cur)
        cy, cx = cur
        for dy, dx, c in nbrs:
            ny, nx = cy + dy, cx + dx
            if not (0 <= ny < H and 0 <= nx < W) or not free[ny, nx]:
                continue
            ng = g[cur] + c
            if ng < g.get((ny, nx), np.inf):
                g[(ny, nx)] = ng
                came[(ny, nx)] = cur
                heapq.heappush(pq, (ng + np.hypot(goal[0] - ny, goal[1] - nx), (ny, nx)))
    return None


def auto_loop_waypoints(gt: GroundTruthMap, n: int = 6,
                        clearance_m: float = 0.3,
                        extent_frac: float = 0.6) -> np.ndarray:
    """Pick n waypoints forming a loop around the free space: for n compass
    directions from the free-space centroid, the farthest reachable free cell
    within extent_frac of the map extent."""
    free = _largest_component(_erode_free(gt, clearance_m))
    ys, xs = np.nonzero(free)
    if len(ys) == 0:
        raise ValueError("no free space after erosion")
    cy, cx = ys.mean(), xs.mean()
    pts = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        d = np.cos(ang) * (xs - cx) + np.sin(ang) * (ys - cy)
        perp = np.abs(-np.sin(ang) * (xs - cx) + np.cos(ang) * (ys - cy))
        score = d - 0.5 * perp
        score = np.where(d <= 0, -np.inf, score)
        idx = int(np.argmax(score))
        # pull toward the centroid a bit for clearance
        wy = cy + (ys[idx] - cy) * extent_frac
        wx = cx + (xs[idx] - cx) * extent_frac
        # snap to nearest free cell
        d2 = (ys - wy) ** 2 + (xs - wx) ** 2
        j = int(np.argmin(d2))
        pts.append((ys[j], xs[j]))
    world = np.array(
        [[gt.origin[0] + (x + 0.5) * gt.resolution,
          gt.origin[1] + (y + 0.5) * gt.resolution] for y, x in pts]
    )
    return world


def plan_loop_path(gt: GroundTruthMap, waypoints_world: np.ndarray,
                   clearance_m: float = 0.3, close_loop: bool = True) -> np.ndarray:
    """A* between consecutive waypoints (wrapping), smoothed; returns a dense
    (M, 2) world-frame polyline."""
    free = _erode_free(gt, clearance_m)
    cells = np.floor((waypoints_world - gt.origin[None, :]) / gt.resolution).astype(int)
    cells = [(int(y), int(x)) for x, y in cells]
    n = len(cells)
    full = []
    pairs = list(range(n if close_loop else n - 1))
    for i in pairs:
        a, b = cells[i], cells[(i + 1) % n]
        seg = _astar(free, a, b)
        if seg is None:
            raise ValueError(f"no path between waypoints {i} and {(i + 1) % n}")
        full.extend(seg[:-1] if i < pairs[-1] else seg)
    path = np.array(
        [[gt.origin[0] + (x + 0.5) * gt.resolution,
          gt.origin[1] + (y + 0.5) * gt.resolution] for y, x in full]
    )
    # moving-average smoothing (keeps endpoints)
    if len(path) > 10:
        k = 7
        pad = np.pad(path, ((k // 2, k // 2), (0, 0)), mode="edge")
        kernel = np.ones(k) / k
        sm = np.stack([np.convolve(pad[:, d], kernel, mode="valid") for d in range(2)], -1)
        path = sm
    return path


def path_to_trajectory(path: np.ndarray, speed: float = 0.5,
                       scan_rate: float = 10.0) -> np.ndarray:
    """Resample a polyline at constant speed; heading = path tangent.
    Returns (N, 4): x, y, theta, t."""
    seg = np.diff(path, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    s = np.concatenate([[0], np.cumsum(seg_len)])
    total = s[-1]
    dt = 1.0 / scan_rate
    n = max(int(total / speed / dt), 2)
    ts = np.arange(n) * dt
    ss = np.minimum(ts * speed, total - 1e-9)
    x = np.interp(ss, s, path[:, 0])
    y = np.interp(ss, s, path[:, 1])
    # tangent heading with smoothing
    dx = np.gradient(x)
    dy = np.gradient(y)
    th = np.arctan2(dy, dx)
    th = np.unwrap(th)
    if n > 10:
        k = 9
        pad = np.pad(th, (k // 2, k // 2), mode="edge")
        th = np.convolve(pad, np.ones(k) / k, mode="valid")
    return np.stack([x, y, th, ts], -1)


def simulate_odometry(gt_poses: np.ndarray, rng: np.random.Generator,
                      odom_error: tuple = (0.03, 0.03, 0.05)) -> np.ndarray:
    """Integrate noisy odometry from true pose deltas (stage-style
    proportional odom error, worlds/icra.world:38/willow-pr2-5cm.world:25):
    each body-frame delta is scaled by (1 + e) with per-run systematic bias
    plus per-step noise."""
    n = gt_poses.shape[0]
    odom = np.zeros((n, 3))
    # stage draws a bounded uniform systematic error per run
    bias = rng.uniform(-1, 1, 3) * np.array(odom_error)
    cur = np.zeros(3)
    for i in range(1, n):
        d = gt_poses[i] - gt_poses[i - 1]
        c, s = np.cos(gt_poses[i - 1, 2]), np.sin(gt_poses[i - 1, 2])
        body = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])
        noise = bias + rng.normal(0, 0.3, 3) * np.array(odom_error)
        body = body * (1.0 + noise)
        c2, s2 = np.cos(cur[2]), np.sin(cur[2])
        cur = np.array([
            cur[0] + c2 * body[0] - s2 * body[1],
            cur[1] + s2 * body[0] + c2 * body[1],
            cur[2] + body[2],
        ])
        odom[i] = cur
    return odom


def simulate_log(gt: GroundTruthMap, laser: LaserModel,
                 trajectory: np.ndarray | None = None,
                 speed: float = 0.5, scan_rate: float = 10.0,
                 odom_error: tuple = (0.03, 0.03, 0.05),
                 range_noise: float = 0.01,
                 n_waypoints: int = 6, seed: int = 0,
                 clearance_m: float = 0.3) -> ScanLog:
    """End-to-end scene simulation → ScanLog with GT poses."""
    rng = np.random.default_rng(seed)
    if trajectory is None:
        wps = auto_loop_waypoints(gt, n=n_waypoints, clearance_m=clearance_m)
        path = plan_loop_path(gt, wps, clearance_m=clearance_m)
        trajectory = path_to_trajectory(path, speed=speed, scan_rate=scan_rate)
    poses = trajectory[:, :3]
    times = trajectory[:, 3]
    odom = simulate_odometry(poses, rng, odom_error)
    ranges = np.stack([
        raycast(gt, poses[i], laser, rng, range_noise) for i in range(len(poses))
    ])
    return ScanLog(ranges=ranges, odom=odom, times=times, laser=laser,
                   gt_poses=poses)
