"""Serial CPU reference of the correlative-match hot loop.

The port's own copy of the JAX package's ``bench/cpu_reference.py`` (NumPy
only): a re-implementation in plain Python/NumPy, written from the
algorithm spec, of the reference's serial candidate scoring
(``MultiResolutionCorrelateScanMatcher::ScanMatch``,
correlate_scan_matcher.h:505-614). It is the numerical ground truth the
batched scoring (``ops/correlative.py::score_candidates`` and the CUDA
kernels behind it) is held against in the tests. The measured single-core
CPU baseline of the benchmark is its C++ twin,
``native/baseline_correlative.cpp`` (``bench/headline.py``).
"""

from __future__ import annotations

import math

import numpy as np


def score_candidates_serial(probs: np.ndarray, default_prob: float,
                            inv_res: float,
                            points: np.ndarray, n_valid: int,
                            center_pose_map: np.ndarray,
                            search_space_size: float,
                            search_space_resolution: float,
                            search_angle_offset: float,
                            search_angle_resolution: float,
                            use_point_size: int):
    """Triple-loop candidate scoring; returns (scores[A,Nx,Ny], angles, xs, ys)."""
    H, W = probs.shape
    map_resolution = 1.0 / inv_res
    n_angles = int(math.floor(search_angle_offset * 2 / search_angle_resolution) + 1)
    n_space = int(round(search_space_size / search_space_resolution) + 1)

    base_angle = center_pose_map[2]
    start_angle = base_angle - search_angle_offset

    P = n_valid
    use = use_point_size
    if P < 2 * use:
        use = P
        step = 1
    else:
        step = P // (use - 1)

    start_x = center_pose_map[0] - (search_space_size / map_resolution) * 0.5
    start_y = center_pose_map[1] - (search_space_size / map_resolution) * 0.5
    space_step = search_space_resolution / map_resolution

    angles = np.zeros(n_angles)
    xs = start_x + np.arange(n_space) * space_step
    ys = start_y + np.arange(n_space) * space_step
    scores = np.zeros((n_angles, n_space, n_space))

    flat = probs.reshape(-1)
    for ai in range(n_angles):
        angle = start_angle + ai * search_angle_resolution
        angles[ai] = angle
        c, s = math.cos(angle), math.sin(angle)
        rx = c * points[:P, 0] * inv_res - s * points[:P, 1] * inv_res
        ry = s * points[:P, 0] * inv_res + c * points[:P, 1] * inv_res
        sample = np.arange(0, P, step)
        for xi in range(n_space):
            x = xs[xi]
            for yi in range(n_space):
                y = ys[yi]
                total = 0.0
                for pi in sample:
                    gx = int(rx[pi] + x + 0.5)
                    gy = int(ry[pi] + y + 0.5)
                    if 0 <= gx < W and 0 <= gy < H:
                        total += flat[gy * W + gx]
                    else:
                        total += default_prob
                scores[ai, xi, yi] = total / use
    return scores, angles, xs, ys


def penalize_serial(scores, angles, xs, ys, center_pose_map, map_resolution,
                    search_space_size, distance_gain, angle_gain=0.25):
    """PenalizeResponse (correlate_scan_matcher.h:718-745)."""
    out = scores.copy()
    for ai in range(scores.shape[0]):
        dth2 = (angles[ai] - center_pose_map[2]) ** 2
        apen = max(1.0 - angle_gain * dth2 / 0.349, 0.9)
        for xi in range(scores.shape[1]):
            for yi in range(scores.shape[2]):
                if abs(scores[ai, xi, yi]) <= 1e-6:
                    continue
                d2 = ((xs[xi] - center_pose_map[0]) ** 2
                      + (ys[yi] - center_pose_map[1]) ** 2)
                d2 *= map_resolution ** 2
                dpen = max(1.0 - distance_gain * d2 / (search_space_size / 2), 0.5)
                out[ai, xi, yi] *= dpen * apen
    return out


def find_best_serial(scores, angles, xs, ys, tol=1e-2):
    """FindBestCandidate tie averaging (correlate_scan_matcher.h:670-710)."""
    order = np.argsort(scores.reshape(-1))[::-1]
    A, Nx, Ny = scores.shape
    flat = scores.reshape(-1)
    best = flat[order[0]]
    pos = np.zeros(2)
    tx = ty = wsum = 0.0
    count = 0
    for idx in order:
        sc = flat[idx]
        if sc - best < -abs(tol):
            break
        ai, xi, yi = idx // (Nx * Ny), (idx // Ny) % Nx, idx % Ny
        pos += np.array([xs[xi], ys[yi]]) * sc
        tx += math.cos(angles[ai]) * sc
        ty += math.sin(angles[ai]) * sc
        wsum += sc
        count += 1
    first = order[0]
    ai, xi, yi = first // (Nx * Ny), (first // Ny) % Nx, first % Ny
    if count > 1 and wsum > 0:
        return np.array([pos[0] / wsum, pos[1] / wsum,
                         math.atan2(ty / wsum, tx / wsum)]), best
    return np.array([xs[xi], ys[yi], angles[ai]]), best
