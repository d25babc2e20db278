"""The Gauss-Newton match kernel (K6, ``ops/cuda/gauss_newton.cu``) held
against its plain version (``ops/gauss_newton.py::optimize_passes_plain``)
on the card, on the same inputs: the scenes it is held on and the bars.

A scene is a room scan (``room_scan``) stamped into the optimize matcher's
coarse map at a known pose (``scene``: one map, or a batch of maps stamped
at poses a few cells apart, as a chain batch's are) and a start pose a few
cells and a few hundredths of a radian away; the edge cases are an empty
scan, a start far off the map, a flat map (H zero but for the 1e-9
ridge, a stop at the second pass) and a ramp map whose first step is
clamped. ``compare`` runs both versions and reports the gaps: the pose in
map cells and radians, the cost relative to the plain one's, and the passes
that differ. Both sum over the points in another order, so the gaps are
float32 rounding; ``BARS`` lie between the sound kernel's gaps and those of
a faulty one (one pass only; the angle's step dropped), both measured on
the card (PERF.md §6).

The JAX package's ``optimize_scan_match`` on the same scenes is stored in
``tests/data/gn_kernel_jax.npz`` (``scripts/torch_gn_kernel_fixture.py``,
on the CPU): the scenes of ``jax_cases`` with JAX's pose, cost and passes.
``compare_jax`` holds the port's ``optimize_scan_match`` (K6 on the card)
against them within ``JAX_BARS``, set the same way.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..backend.processor import Backend
from ..config import SlamConfig
from ..frontend.processor import FrontendSpec
from ..models.grid_map import ProbMapSpec, backend_map_specs, make_prob_map
from ..ops import gauss_newton as gn
from ..ops.cuda import gauss_newton as gn_kernel
from ..ops.raster import stamp_scan

# the largest gaps a sound kernel may show against the plain loop
BARS = {"pose_gap_cells": 1e-3, "angle_gap_rad": 1e-4, "cost_rel_gap": 1e-3,
        "passes_differing": 0}
# ... and against the JAX package's stored results
JAX_BARS = {"pose_gap_cells": 1e-3, "angle_gap_rad": 1e-4, "cost_rel_gap": 1e-3,
            "passes_differing": 0}


def params_of(config: SlamConfig, **over) -> gn.OptimizeParams:
    """The optimize matcher's parameters of ``config``, ``over`` laid on."""
    p = gn.OptimizeParams(config.iterate_times, config.cost_decrease_threshold,
                          config.cost_min_threshold, config.max_update_distance,
                          config.max_update_angle)
    return dataclasses.replace(p, **over)


def room_scan(points: int, seed: int, beams: int = 1081):
    """A 270° scan of ``beams`` beams from the middle of a 9 m x 7 m room
    with two pillars, 1 cm range noise, padded with masked slots to
    ``points``: (points (P, 2) float32, mask (P,) bool)."""
    rng = np.random.default_rng(seed)
    n = min(beams, points)
    ang = np.linspace(-0.75 * math.pi, 0.75 * math.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    with np.errstate(divide="ignore"):
        r = np.minimum(np.where(d[:, 0] != 0, np.abs(4.5 / d[:, 0]), np.inf),
                       np.where(d[:, 1] != 0, np.abs(3.5 / d[:, 1]), np.inf))
    for cx, cy, rad in ((2.0, 1.0, 0.3), (-1.5, -2.0, 0.4)):
        b = d @ np.array([cx, cy])
        disc = b * b - (cx * cx + cy * cy - rad * rad)
        hit = (disc > 0) & (b - np.sqrt(np.maximum(disc, 0)) > 0)
        r = np.where(hit, np.minimum(r, b - np.sqrt(np.maximum(disc, 0))), r)
    r = r + rng.normal(0.0, 0.01, n)
    pts = np.zeros((points, 2), np.float32)
    pts[:n] = d * r[:, None]
    mask = np.zeros(points, bool)
    mask[:n] = True
    return pts, mask


def scene(spec: ProbMapSpec, points: int, batch: int, seed: int, device):
    """A room scan and ``batch`` coarse maps of ``spec`` stamped from it at
    poses a few cells apart round the map's middle (one map of (H, W) where
    ``batch`` is None, else (B, H, W)), and start poses in map cells a few
    cells and hundredths of a radian from them: (probs, points, mask, pose0
    (B, 3) or (1, 3))."""
    rng = np.random.default_rng(seed)
    pts, msk = room_scan(points, seed)
    pts_t = torch.as_tensor(pts, device=device)
    msk_t = torch.as_tensor(msk, device=device)
    mid = 0.5 * np.array([spec.width, spec.height]) * spec.resolution
    maps, starts = [], []
    for _ in range(batch or 1):
        pose = np.array([*(rng.normal(0.0, 0.2, 2)), rng.normal(0.0, 0.05)])
        pmap = make_prob_map(spec, torch.as_tensor(mid, dtype=torch.float32), device)
        stamp_scan(spec, pmap, pts_t, msk_t, torch.as_tensor(pose, dtype=torch.float32,
                                                             device=device))
        maps.append(pmap.probs)
        start = (pose[:2] + mid) * spec.inv_res + rng.normal(0.0, 1.5, 2)
        starts.append([*start, pose[2] + rng.normal(0.0, 0.03)])
    probs = maps[0] if batch is None else torch.stack(maps)
    pose0 = torch.as_tensor(np.array(starts), dtype=torch.float32, device=device)
    return probs, pts_t, msk_t, pose0


def edge_scenes(spec: ProbMapSpec, points: int, device) -> dict:
    """The edge cases, each (probs, points, mask, pose0, parameter
    overrides): an empty scan, a start far off the map, a flat map, and a
    ramp map (probabilities rising along x) taken one pass, whose step
    the clamp cuts."""
    probs, pts, msk, pose0 = scene(spec, points, None, 7, device)
    flat = torch.full_like(probs, spec.default_prob)
    x = torch.arange(spec.width, dtype=torch.float32, device=device) / spec.width
    ramp = (0.05 + 0.9 * x)[None, :].expand(spec.height, spec.width).contiguous()
    far = torch.tensor([[-5000.0, -7000.0, 1.0]], device=device)
    return {"empty": (probs, pts, torch.zeros_like(msk), pose0, {}),
            "off_map": (probs, pts, msk, far, {}),
            "flat": (flat, pts, msk, pose0, {}),
            "clamped": (ramp, pts, msk, pose0, {"iterate_max_times": 1})}


def compare(spec: ProbMapSpec, params: gn.OptimizeParams, probs, points, mask, pose0,
            kernel_params: gn.OptimizeParams | None = None) -> dict:
    """K6 (with ``kernel_params``, default ``params``: a faulty reading
    changes them) and the plain loop on the same inputs: the largest pose
    gap in map cells and in radians, the largest cost gap relative to the
    plain cost, the passes that differ, both versions' passes, and whether
    a second launch repeats the first bit for bit."""
    kp = params if kernel_params is None else kernel_params
    got = gn_kernel.match(probs, points, mask, pose0, spec.inv_res, kp)
    again = gn_kernel.match(probs, points, mask, pose0, spec.inv_res, kp)
    want = gn.optimize_passes_plain(spec, params, probs, points, mask, pose0)
    pose, cost, passes = (t.double().cpu() for t in got)
    wpose, wcost, wpasses = (t.double().cpu() for t in want)
    return {"shape": [int(pose0.shape[0]), int(points.shape[0]), spec.height, spec.width],
            "pose_gap_cells": float((pose[:, :2] - wpose[:, :2]).abs().max()),
            "angle_gap_rad": float((pose[:, 2] - wpose[:, 2]).abs().max()),
            "cost_rel_gap": float(((cost - wcost).abs() / wcost.abs().clamp(min=1e-12)).max()),
            "passes_differing": int((passes != wpasses).sum()),
            "passes": passes.long().tolist(), "plain_passes": wpasses.long().tolist(),
            "repeats_its_bits": all(torch.equal(a, b) for a, b in zip(got, again))}


def held(r: dict) -> bool:
    """Whether a sound kernel's reading keeps within ``BARS``."""
    return r["repeats_its_bits"] and all(r[k] <= v for k, v in BARS.items())


def cell_specs(config: SlamConfig | None = None) -> dict:
    """The optimize matcher's coarse map specs in ``default.corridor_lap``
    (``SlamConfig()`` and a 10 m lidar in the derived 50 m world): the
    front end's 512² map and a chain's 256² one."""
    cfg = SlamConfig() if config is None else config
    fspec = FrontendSpec.from_config(cfg, 10.0, cfg.derived_world_size(10.0))
    return {"front": fspec.coarse_spec, "chain": backend_map_specs(cfg, 10.0)[0]}


def jax_cases(config: SlamConfig | None = None) -> dict:
    """The scenes whose JAX results are stored, built on the CPU, name →
    (side, probs, points, mask, offset (2,), pose_world (B, 3), params): the
    front end's map (seed 11), a chain batch of the largest bucket (seed
    12; the bucket of ``b`` takes its first ``b`` maps and poses) and the
    four edge cases of ``edge_scenes`` on the front end's map. Offsets are
    the scenes' map middles, the world poses those of their cell poses."""
    cfg = SlamConfig() if config is None else config
    specs = cell_specs(cfg)
    out = {}

    def add(name, side, probs, pts, msk, pose0, over):
        spec = specs[side]
        mid = 0.5 * np.array([spec.width, spec.height]) * spec.resolution
        world = pose0.double().numpy().copy()
        world[:, :2] = world[:, :2] / spec.inv_res - mid
        out[name] = (side, probs, pts, msk, torch.as_tensor(mid, dtype=torch.float32),
                     torch.as_tensor(world, dtype=torch.float32), params_of(cfg, **over))

    add("front", "front", *scene(specs["front"], cfg.max_points, None, 11, "cpu"), {})
    add("chain", "chain",
        *scene(specs["chain"], cfg.max_points, Backend._BATCH_BUCKETS[-1], 12, "cpu"), {})
    for name, (probs, pts, msk, pose0, over) in edge_scenes(
            specs["front"], cfg.max_points, "cpu").items():
        add(name, "front", probs, pts, msk, pose0, over)
    return out


def compare_jax(spec: ProbMapSpec, params: gn.OptimizeParams, probs, offset, points, mask,
                pose_world, jax_pose, jax_cost, jax_passes) -> dict:
    """The port's ``optimize_scan_match`` (K6 for tensors on the card, the
    plain loop on the CPU) against the JAX package's stored pose (world),
    cost and passes: the largest pose gap in map cells and in radians
    (wrapped), the largest cost gap relative to JAX's, and the passes that
    differ."""
    res = gn.optimize_scan_match(spec, params, probs, offset, points, mask, pose_world)
    pose = res.pose.double().cpu().numpy().reshape(-1, 3)
    cost = res.cost.double().cpu().numpy().reshape(-1)
    passes = res.passes.long().cpu().numpy().reshape(-1)
    jp, jc = np.asarray(jax_pose, np.float64).reshape(-1, 3), np.asarray(jax_cost, np.float64)
    dth = pose[:, 2] - jp[:, 2]
    return {"shape": [len(pose), int(points.shape[0]), spec.height, spec.width],
            "pose_gap_cells": float(np.abs(pose[:, :2] - jp[:, :2]).max() * spec.inv_res),
            "angle_gap_rad": float(np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max()),
            "cost_rel_gap": float((np.abs(cost - jc) / np.maximum(np.abs(jc), 1e-12)).max()),
            "passes_differing": int((passes != np.asarray(jax_passes).reshape(-1)).sum()),
            "passes": passes.tolist(), "jax_passes": np.asarray(jax_passes).tolist()}


def held_jax(r: dict) -> bool:
    """Whether a reading against JAX keeps within ``JAX_BARS``."""
    return all(r[k] <= v for k, v in JAX_BARS.items())
