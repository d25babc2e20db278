"""Offline visualization — the reference's rviz output, decoupled.

Own copy of the JAX package's ``utils/viz.py`` for the port's engine. The
reference publishes the occupancy grid at 1 Hz and the pose graph as
rviz marker arrays (PublishMapThread / PublishVisualization,
roborts_slam_node.cpp:355-488, :198-288). Offline equivalents:

- ``save_pgm``: the published map as a PGM image (the format the reference's
  GT maps ship in), cropped to the touched bound box like the reference's
  publisher (:427-469).
- ``render_run``: map + trajectory + graph edges + loop closures as a PNG
  (matplotlib, imported only inside it: the package does not depend on
  it, and ``render_run`` raises ``ImportError`` where it is missing).
"""

from __future__ import annotations

import os

import numpy as np


def pub_map_image(states: np.ndarray) -> np.ndarray:
    """GridStates (-1/0/100) -> grayscale (205 unknown, 254 free, 0 occu),
    the PGM convention of the reference's map assets."""
    return np.where(states == -1, 205,
                    np.where(states == 100, 0, 254)).astype(np.uint8)


def crop_to_content(states: np.ndarray, pad: int = 8):
    """Bound-box crop of known cells (GetStartGrid/GetEndGrid publishing
    extents, grid_map_base.h:319-328). Returns (cropped, (y0, x0))."""
    known = states != -1
    if not known.any():
        return states, (0, 0)
    ys, xs = np.nonzero(known)
    y0 = max(int(ys.min()) - pad, 0)
    y1 = min(int(ys.max()) + pad + 1, states.shape[0])
    x0 = max(int(xs.min()) - pad, 0)
    x1 = min(int(xs.max()) + pad + 1, states.shape[1])
    return states[y0:y1, x0:x1], (y0, x0)


def save_pgm(states: np.ndarray, path: str, crop: bool = True) -> None:
    img = pub_map_image(crop_to_content(states)[0] if crop else states)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img[::-1].tobytes())      # PGM rows top-down; map rows are +y


def save_map(engine, path: str, crop: bool = True) -> None:
    """Save the publish map as a map_server-style PGM + YAML pair — the
    format the reference's GT map assets use (maps/*.pgm + maps/*.yaml:
    image/resolution/origin/negate/occupied_thresh/free_thresh), so maps
    built here drop into any consumer of that convention.

    ``path`` may end in ``.pgm`` or be an extensionless stem."""
    stem = path[:-4] if path.endswith(".pgm") else path
    states = engine.get_pub_map()
    cropped, (y0, x0) = (crop_to_content(states) if crop
                         else (states, (0, 0)))
    save_pgm(cropped, stem + ".pgm", crop=False)
    res = engine.fspec.pub_spec.resolution
    off = engine.state.pub.offset.cpu().numpy().astype(np.float64)
    # origin = world coords of the PGM's lower-left pixel
    origin = [float(x0 * res - off[0]), float(y0 * res - off[1]), 0.0]
    with open(stem + ".yaml", "w") as f:
        f.write(f"image: {os.path.basename(stem)}.pgm\n"
                f"resolution: {res}\n"
                f"origin: [{origin[0]:.6f}, {origin[1]:.6f}, 0.000000]\n"
                f"negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")


def render_run(engine, path: str, gt_poses: np.ndarray | None = None,
               dpi: int = 130) -> None:
    """Map + estimated trajectory + graph edges (+ GT overlay) to PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    states = engine.get_pub_map()
    cropped, (y0, x0) = crop_to_content(states)
    res = engine.fspec.pub_spec.resolution
    off = engine.state.pub.offset.cpu().numpy().astype(np.float64)

    fig, ax = plt.subplots(figsize=(9, 9))
    extent_m = [
        x0 * res - off[0], (x0 + cropped.shape[1]) * res - off[0],
        y0 * res - off[1], (y0 + cropped.shape[0]) * res - off[1],
    ]
    ax.imshow(pub_map_image(cropped), cmap="gray", origin="lower",
              extent=extent_m, vmin=0, vmax=255)

    nodes, edges = engine.backend.graph_info()
    for a, b in edges:
        ax.plot([a[0], b[0]], [a[1], b[1]], color="#3b82f6", lw=0.5,
                alpha=0.6, zorder=2)
    traj = engine.trajectory_array()
    if len(traj):
        ax.plot(traj[:, 1], traj[:, 2], color="#dc2626", lw=1.4, zorder=3,
                label="estimate")
    if gt_poses is not None:
        # GT lives in the scene-map frame; SLAM starts at the origin.
        # Re-base GT relative to its own first pose.
        g0 = gt_poses[0]
        c, s = np.cos(-g0[2]), np.sin(-g0[2])
        dx, dy = gt_poses[:, 0] - g0[0], gt_poses[:, 1] - g0[1]
        gx = c * dx - s * dy
        gy = s * dx + c * dy
        ax.plot(gx, gy, color="#16a34a", lw=1.0,
                ls="--", zorder=3, label="ground truth")
    if len(nodes):
        ax.scatter(nodes[:, 0], nodes[:, 1], s=4, color="#1d4ed8", zorder=4)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"{engine.diag.scans_processed} scans, "
                 f"{engine.backend.num_links} links, "
                 f"{engine.diag.loop_closures} loop closures")
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
