"""SlamEngine — the top-level online SLAM loop (blocking path).

Counterpart of the JAX package's ``engine.py`` (``SlamNode`` +
``SlamProcessor`` orchestration, src/roborts_slam_node.cpp,
src/slam/slam_processor.cpp): consumes a scan stream scan by scan, runs the
front-end step, maintains the scan store (the reference's
SensorDataManager), and drives the back end (pose graph + loop closure)
synchronously after every kept scan.

This slice carries the blocking per-scan loop only. The asynchronous
back-end worker, the pipelined fetch, the fused front-end+chain step, the
windowed (running-range) match, the rolling match-map window, odometry
de-distortion, the pose stream and the map-snapshot hooks are not ported:
asking for one raises ``NotImplementedError``.

All device state lives on one explicit ``device``. ``device=None`` means
the card and raises when there is none; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time as _time
import warnings

import numpy as np
import torch

from .config import SlamConfig
from .backend.processor import Backend, BackendSpec
from .frontend.processor import (
    FrontendSpec, FrontendState, frontend_step, init_frontend_state,
)
from .models.scan import LaserModel, ranges_to_packed
from .models.grid_map import CountMap, ProbMap, count_map_states
from .ops.raster import rebuild_count_map, stamp_scan_batch


def resolve_device(device) -> torch.device:
    """``None`` -> the card (raises without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _rebuild_all_maps(pub_spec, coarse_spec, fine_spec,
                      pub_off, coarse_off, fine_off,
                      pts, msk, poses, valid, free_f, occu_f,
                      first_scan_extra: int, coarse_blur: bool,
                      fine_blur: bool):
    """The full CorrectPoseAndMap rebuild (pub + coarse + fine,
    slam_processor.cpp:350-366) from every stored scan."""
    dev = pts.device
    pub = rebuild_count_map(pub_spec, pub_off, pts, msk, poses, valid,
                            free_f, occu_f, first_scan_extra=first_scan_extra)

    def fresh(spec, off):
        return ProbMap(torch.full((spec.height, spec.width), spec.default_prob,
                                  dtype=torch.float32, device=dev), off)

    coarse = stamp_scan_batch(coarse_spec, fresh(coarse_spec, coarse_off),
                              pts, msk, poses, valid, use_blur=coarse_blur)
    fine = stamp_scan_batch(fine_spec, fresh(fine_spec, fine_off),
                            pts, msk, poses, valid, use_blur=fine_blur)
    return pub, coarse, fine


class ScanStore:
    """Append-only store of accepted scans (SensorDataManager,
    src/slam/sensor_data_manager.h:349-595). One copy per scan in
    sensor-local meters on the host, plus a device mirror: plain
    preallocated tensors (capacity doubling) written in place, which the
    back end's chain matches gather from by id."""

    _DEV_CAP_START = 256

    def __init__(self, max_points: int, device):
        self.max_points = max_points
        self.device = torch.device(device)
        self._points: list[np.ndarray] = []
        self._masks: list[np.ndarray] = []
        self._n_valid: list[int] = []
        self._centroids: list[np.ndarray] = []   # local-frame point centroid
        self._local_bboxes: list[tuple] = []     # (min_xy, max_xy) local
        self.poses: list[np.ndarray] = []        # world poses (mutable on correction)
        self.odoms: list[np.ndarray] = []
        self.times: list[float] = []
        # (pub_spec, hits, passes, offset) — one tuple so the back end always
        # pairs arrays with the spec they were built under (the pub map can
        # grow mid-run)
        self._pub_arrays = None
        # incremental barycenter cache: O(1) append, invalidated only by
        # pose corrections
        self._bary = np.zeros((256, 3), np.float64)
        self._bary_dirty_from = 0
        # device mirror
        self._dev_points = None
        self._dev_masks = None
        self._dev_poses = None
        self._dev_cap = 0
        self._dev_count = 0
        self._dev_poses_stale = True

    def __len__(self):
        return len(self._points)

    def n_valid(self, scan_id: int) -> int:
        return self._n_valid[scan_id]

    def add(self, points: np.ndarray, mask: np.ndarray, n_valid: int,
            pose: np.ndarray, odom: np.ndarray, t: float) -> int:
        # defensive copies: callers may reuse their scan buffers between
        # calls; the store owns its data
        points = np.array(points, np.float32, copy=True)
        mask = np.array(mask, bool, copy=True)
        self._points.append(points)
        self._masks.append(mask)
        self._n_valid.append(int(n_valid))
        w = mask.astype(np.float64)
        denom = max(w.sum(), 1.0)
        self._centroids.append((points * w[:, None]).sum(0) / denom)
        # sensor-local endpoint bbox, cached for O(scans) world-bbox
        # queries after pose corrections (4-corner transform per scan)
        pv = points[mask]
        self._local_bboxes.append(
            (pv.min(0), pv.max(0)) if len(pv)
            else (np.zeros(2, np.float32), np.zeros(2, np.float32)))
        self.poses.append(np.asarray(pose, np.float64).copy())
        self.odoms.append(np.asarray(odom, np.float64).copy())
        self.times.append(float(t))
        sid = len(self._points) - 1
        if sid >= self._bary.shape[0]:
            grown = np.zeros((2 * self._bary.shape[0], 3), np.float64)
            grown[:self._bary.shape[0]] = self._bary
            self._bary = grown
        return sid

    def set_pose(self, scan_id: int, pose: np.ndarray):
        self.poses[scan_id] = np.asarray(pose, np.float64).copy()
        self._bary_dirty_from = min(self._bary_dirty_from, scan_id)
        self._dev_poses_stale = True

    def poses_array(self) -> np.ndarray:
        return np.asarray(self.poses)

    def scans_world_bbox(self):
        """Union world bbox over every stored scan's endpoints (bounded by
        the rotated local bbox corners) plus the sensor positions (carve
        rays start there). O(scans) via the cached local bboxes — used to
        grow the pub map before a correction rebuild so arbitrarily moved
        poses never stamp clipped."""
        n = len(self)
        if n == 0:
            return None
        lo = np.stack([b[0] for b in self._local_bboxes])   # (n, 2)
        hi = np.stack([b[1] for b in self._local_bboxes])
        poses = np.asarray(self.poses)
        cx = np.stack([lo[:, 0], lo[:, 0], hi[:, 0], hi[:, 0]], 1)  # (n, 4)
        cy = np.stack([lo[:, 1], hi[:, 1], lo[:, 1], hi[:, 1]], 1)
        c = np.cos(poses[:, 2])[:, None]
        s = np.sin(poses[:, 2])[:, None]
        wx = poses[:, 0:1] + c * cx - s * cy
        wy = poses[:, 1:2] + s * cx + c * cy
        bmin = np.array([min(wx.min(), poses[:, 0].min()),
                         min(wy.min(), poses[:, 1].min())])
        bmax = np.array([max(wx.max(), poses[:, 0].max()),
                         max(wy.max(), poses[:, 1].max())])
        return bmin, bmax

    def _bary_of(self, ids) -> np.ndarray:
        """pose ⊕ local centroid, keeping yaw (UpdateBarycenterPose,
        sensor_data_manager.h:214-238)."""
        poses = np.asarray([self.poses[i] for i in ids])
        cent = np.asarray([self._centroids[i] for i in ids])
        c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
        bx = poses[:, 0] + c * cent[:, 0] - s * cent[:, 1]
        by = poses[:, 1] + s * cent[:, 0] + c * cent[:, 1]
        return np.stack([bx, by, poses[:, 2]], -1)

    def barycenters(self) -> np.ndarray:
        """World barycenter pose per scan, served from the incremental
        cache: appends fill rows as scans arrive; pose corrections mark a
        dirty suffix that is recomputed lazily in one vectorized pass."""
        n = len(self)
        if self._bary_dirty_from < n:
            ids = range(self._bary_dirty_from, n)
            self._bary[self._bary_dirty_from:n] = self._bary_of(ids)
            self._bary_dirty_from = n
        return self._bary[:n]

    def pub_map_arrays(self):
        return self._pub_arrays

    def device_arrays(self):
        """Device-resident ``(points (cap,P,2), masks (cap,P), poses
        (cap,3))`` of every stored scan. Capacity doubles (one re-upload per
        doubling); otherwise each new scan is one in-place row write. Poses
        re-upload whole (tiny) only after ``set_pose`` invalidated them."""
        n = len(self)
        dev = self.device
        if self._dev_points is None or n > self._dev_cap:
            cap = self._DEV_CAP_START
            while cap < n:
                cap *= 2
            self._dev_points = torch.zeros((cap, self.max_points, 2),
                                           dtype=torch.float32, device=dev)
            self._dev_masks = torch.zeros((cap, self.max_points),
                                          dtype=torch.bool, device=dev)
            self._dev_poses = torch.zeros((cap, 3), dtype=torch.float32,
                                          device=dev)
            self._dev_cap = cap
            self._dev_count = 0
            self._dev_poses_stale = True
        while self._dev_count < n:
            i = self._dev_count
            self._dev_points[i] = torch.as_tensor(self._points[i], device=dev)
            self._dev_masks[i] = torch.as_tensor(self._masks[i], device=dev)
            self._dev_poses[i] = torch.as_tensor(
                self.poses[i], dtype=torch.float32, device=dev)
            self._dev_count = i + 1
        if self._dev_poses_stale and n:
            self._dev_poses[:n] = torch.as_tensor(
                self.poses_array(), dtype=torch.float32, device=dev)
        self._dev_poses_stale = False
        return self._dev_points, self._dev_masks, self._dev_poses

    def all_arrays(self):
        """Every stored scan as device tensors ``(points (n,P,2), masks
        (n,P), poses (n,3), valid (n,))`` — views of the device mirror."""
        pts, msk, poses = self.device_arrays()
        n = len(self)
        valid = torch.ones((n,), dtype=torch.bool, device=self.device)
        return pts[:n], msk[:n], poses[:n], valid


@dataclasses.dataclass
class EngineDiagnostics:
    scans_in: int = 0
    scans_processed: int = 0
    scans_dropped_gate: int = 0
    scans_dropped_move: int = 0
    loop_closures: int = 0
    pub_clip_rebuilds: int = 0     # post-match growth events (_ensure_pub_covers)
    match_time_s: float = 0.0
    backend_time_s: float = 0.0


class SlamEngine:
    """Online SLAM over a scan stream (blocking per-scan loop)."""

    def __init__(self, config: SlamConfig, laser: LaserModel,
                 world_size: float | None = None,
                 synchronous_backend: bool = True,
                 fused_backend: bool = False,
                 pipelined_fetch: bool = False,
                 device=None):
        unsupported = {
            "synchronous_backend=False (async back-end worker)":
                not synchronous_backend,
            "fused_backend (fused front-end+chain step)": fused_backend,
            "pipelined_fetch": pipelined_fetch,
            "use_running_range_scan_match (windowed match)":
                config.use_running_range_scan_match,
            "use_odom_correct (sweep de-distortion)": config.use_odom_correct,
            "match_map_window > 0 (rolling match-map window)":
                config.match_map_window > 0,
        }
        for what, asked in unsupported.items():
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported yet: this slice carries the "
                    f"blocking per-scan loop only")
        self.device = resolve_device(device)
        self.config = config
        self.laser = laser
        # requested world extent (pre-rounding)
        self.world_size = (world_size if world_size is not None
                           else config.derived_world_size(laser.range_max))
        self.fspec = FrontendSpec.from_config(config, laser.range_max,
                                              self.world_size)
        self.bspec = BackendSpec.from_config(config, laser.range_max,
                                             self.fspec.pub_spec)
        self.state: FrontendState = init_frontend_state(self.fspec, self.device)
        # host mirror of the tiny, rarely-changing bits of device state
        # (current pose + map offsets): the per-scan geometry checks read
        # these instead of fetching. Updated from the one per-scan summary
        # fetch, on growth and on corrections.
        self._host_pose = np.zeros(3)
        self._host_fine_off = self.state.fine.offset.cpu().numpy().astype(np.float64)
        self._host_pub_off = self.state.pub.offset.cpu().numpy().astype(np.float64)
        self.store = ScanStore(config.max_points, self.device)
        self.backend = Backend(self.bspec, self.store)
        self.backend.on_corrections = self._apply_corrections
        self.synchronous_backend = True
        self.diag = EngineDiagnostics()
        self._bounds_warned = False
        self.trajectory: list[tuple[float, np.ndarray]] = []  # (t, pose) per kept scan
        self._last_kept_odom: np.ndarray | None = None
        self._last_process_time: float | None = None
        self._pending_backend: list[tuple] = []   # (scan_id, cov)

    # ---- gates (MoveEnough, slam_processor.cpp:604-616) ----

    def _publish_pub_arrays(self):
        """Install the feedback pub-map arrays the back end reads
        (ScanStore.pub_map_arrays): the live state tensors, paired with
        their spec."""
        pub = self.state.pub
        self.store._pub_arrays = (self.fspec.pub_spec, pub.hits, pub.passes,
                                  pub.offset)

    def _move_enough(self, odom: np.ndarray, t: float) -> bool:
        cfg = self.config
        if not cfg.use_odometry or not cfg.use_move_check:
            return True
        ref = self._last_kept_odom
        if ref is None:
            return True
        if (self._last_process_time is not None
                and t - self._last_process_time > cfg.move_time_threshold):
            return True
        d = odom[:2] - ref[:2]
        if np.hypot(d[0], d[1]) >= cfg.move_distance_threshold:
            return True
        dth = np.arctan2(np.sin(odom[2] - ref[2]), np.cos(odom[2] - ref[2]))
        return abs(dth) >= cfg.move_angle_threshold

    # ---- main entry ----

    def process(self, ranges: np.ndarray, odom: np.ndarray, t: float) -> bool:
        """Feed one scan (raw ranges); returns True if accepted."""
        # move gate BEFORE any conversion work — rejected scans must cost
        # nothing on the ingest path (MoveEnough runs first in the
        # reference too, slam_processor.cpp:92)
        if not self._pass_move_gate(odom, t):
            return False
        points, mask, n_valid = ranges_to_packed(
            ranges, self.laser, self.config.max_points)
        return self._process_gated(points, mask, n_valid, odom, t)

    def process_points(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Feed one pre-converted scan (sensor-local cartesian points,
        front-packed mask)."""
        if not self._pass_move_gate(odom, t):
            return False
        return self._process_gated(points, mask, n_valid, odom, t)

    def _pass_move_gate(self, odom: np.ndarray, t: float) -> bool:
        self.diag.scans_in += 1
        if self._move_enough(np.asarray(odom, np.float64), t):
            return True
        self.diag.scans_dropped_move += 1
        return False

    def _process_gated(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Run the front-end step on an already-gated, already-converted
        scan (both ingest paths funnel here)."""
        self._last_process_time = t
        np_points = np.asarray(points, np.float32)
        np_mask = np.asarray(mask, bool)
        odom = np.asarray(odom, np.float64)
        # grow the pub map BEFORE the step so this scan lands unclipped
        # (UpdateBound runs inside UpdateMapByRange in the reference,
        # grid_map_base.h:257-274); the predicted pose is within the search
        # window of the matched pose
        self._maybe_grow_pub(self._predict_pose_host(odom), np_points, np_mask)
        dev = self.device
        t0 = _time.perf_counter()
        self.state, info = frontend_step(
            self.fspec, self.state,
            torch.as_tensor(np_points, device=dev),
            torch.as_tensor(np_mask, device=dev), int(n_valid),
            torch.as_tensor(odom, dtype=torch.float32, device=dev))
        # the step fetched ONE packed summary — pose + cov + gates
        s = info.summary
        accepted = bool(s[12] > 0.5)
        pose = s[:3].copy()
        cov = s[3:12].reshape(3, 3).copy()
        # summary's pose IS the new state.pose, so the mirror updates
        # unconditionally
        self._host_pose = pose.copy()
        self._publish_pub_arrays()
        self.diag.match_time_s += _time.perf_counter() - t0

        if not accepted:
            self.diag.scans_dropped_gate += 1
            return False

        self.diag.scans_processed += 1
        self._check_world_bounds(pose)
        self._last_kept_odom = odom.copy()
        scan_id = self.store.add(np_points, np_mask, n_valid, pose, odom, t)
        self.trajectory.append((t, pose))
        self._ensure_pub_covers(pose, np_points, np_mask)

        self._pending_backend.append((scan_id, cov))
        self.process_backend()
        return True

    def process_backend(self):
        """Drain the back-end buffer (BackEndProcessThread,
        slam_processor.cpp:384-426): graph updates for every pending scan,
        then one loop-closure attempt at the newest."""
        if not self._pending_backend:
            return
        t0 = _time.perf_counter()
        last_id = self._pending_backend[-1][0]
        while self._pending_backend:
            sid, cov = self._pending_backend.pop(0)
            self.backend.update_graph(sid, cov)
        self.backend.try_close_loop(last_id)
        self.diag.loop_closures = self.backend.num_loop_closures
        self.diag.backend_time_s += _time.perf_counter() - t0

    def _check_world_bounds(self, pose: np.ndarray):
        """The fine and coarse *match* maps keep the preallocated world
        extent; warn loudly (once) when the trajectory nears their edge —
        the fix is a larger ``world_size``. The pub map itself grows on
        demand (_maybe_grow_pub)."""
        if self._bounds_warned:
            return
        off = self._host_fine_off
        res = self.fspec.fine_spec.resolution
        extent = np.array([self.fspec.fine_spec.width,
                           self.fspec.fine_spec.height]) * res
        cell = pose[:2] + off
        margin = self.laser.range_max * 0.5
        if (cell < margin).any() or (cell > extent - margin).any():
            warnings.warn(
                f"pose {pose[:2]} within {margin:.1f} m of the preallocated "
                f"match-map edge (extent {extent}); matching will degrade — "
                f"increase world_size",
                RuntimeWarning, stacklevel=3)
            self._bounds_warned = True

    # ---- pub map growth (GridMapBase::UpdateBound/ExtendSize,
    #      grid_map_base.h:188-274) ----

    _PUB_GROW_ALIGN = 256    # growth granularity (cells)

    def _predict_pose_host(self, odom: np.ndarray) -> np.ndarray:
        """Host-side copy of predict_pose_by_odom (slam_processor.cpp:618-634)
        for pre-step geometry checks — reads the host pose mirror."""
        pose = self._host_pose.copy()
        if not self.config.use_odometry or self._last_kept_odom is None:
            return pose
        lo = self._last_kept_odom
        dth = pose[2] - lo[2]
        c, s = np.cos(dth), np.sin(dth)
        tx = pose[0] - (c * lo[0] - s * lo[1])
        ty = pose[1] - (s * lo[0] + c * lo[1])
        return np.array([c * odom[0] - s * odom[1] + tx,
                         s * odom[0] + c * odom[1] + ty,
                         dth + odom[2]])

    def _search_pad(self) -> float:
        """Slack (m) the pre-step pub growth adds around the PREDICTED scan
        bbox: the matched pose can translate from the prediction by at most
        the stacked correlative search half-windows (coarse, fine, then
        super-fine refinements, scan_matchers.h:307-355), plus cell-rounding
        slack. Rotational search can move endpoints further; that tail is
        caught exactly by the post-match clip check (_ensure_pub_covers)."""
        cfg = self.config
        return (0.5 * (cfg.coarse_search_space_size
                       + cfg.fine_search_space_size
                       + cfg.super_fine_search_space_size)
                + 2.0 * self.fspec.pub_spec.resolution)

    def _grow_pub_to_bbox(self, bmin: np.ndarray, bmax: np.ndarray) -> bool:
        """Grow the pub map (never shrinks) so [bmin, bmax] (world meters)
        is inside its extent; returns True if it grew."""
        spec = self.fspec.pub_spec
        res = spec.resolution
        off = self._host_pub_off
        extent = np.array([spec.width, spec.height]) * res      # (x, y) m
        need_lo = np.maximum(0.0, -(np.asarray(bmin) + off))    # m past low edge
        need_hi = np.maximum(0.0, (np.asarray(bmax) + off) - extent)
        if (need_lo <= 0).all() and (need_hi <= 0).all():
            return False
        align = self._PUB_GROW_ALIGN
        cells = lambda m: (-(-np.ceil(m / res).astype(np.int64) // align)
                           * align)
        grow_lo = np.where(need_lo > 0, cells(need_lo), 0)      # (x, y) cells
        grow_hi = np.where(need_hi > 0, cells(need_hi), 0)
        self._grow_pub_to(spec.width + int(grow_lo[0] + grow_hi[0]),
                          spec.height + int(grow_lo[1] + grow_hi[1]),
                          int(grow_lo[0]), int(grow_lo[1]))
        return True

    def _scan_world_bbox(self, pose: np.ndarray, points: np.ndarray,
                         mask: np.ndarray):
        pts = points[mask]
        c, s = np.cos(pose[2]), np.sin(pose[2])
        if len(pts):
            wx = pose[0] + c * pts[:, 0] - s * pts[:, 1]
            wy = pose[1] + s * pts[:, 0] + c * pts[:, 1]
        else:
            wx = wy = np.zeros(0)
        bmin = np.array([min(wx.min(initial=pose[0]), pose[0]),
                         min(wy.min(initial=pose[1]), pose[1])])
        bmax = np.array([max(wx.max(initial=pose[0]), pose[0]),
                         max(wy.max(initial=pose[1]), pose[1])])
        return bmin, bmax

    def _maybe_grow_pub(self, pose: np.ndarray, points: np.ndarray,
                        mask: np.ndarray):
        """Grow the published map so this scan's world bound box fits — the
        equivalent of the reference's dynamic map resize (``UpdateBound``
        grows the allocation to the scan bbox and copies old cells in,
        grid_map_base.h:188-274). Runs BEFORE the step; re-allocation in
        256-cell steps. The pad covers the match-vs-predict translation
        bound (_search_pad); anything beyond it (rotational search) is
        caught post-match by _ensure_pub_covers."""
        bmin, bmax = self._scan_world_bbox(pose, points, mask)
        pad = self._search_pad()
        self._grow_pub_to_bbox(bmin - pad, bmax + pad)

    def _ensure_pub_covers(self, pose: np.ndarray, points: np.ndarray,
                           mask: np.ndarray):
        """Post-match safety net: if the ACCEPTED pose moved the scan's
        endpoints past the pub extent despite the pre-step pad (a large
        rotational correction can), grow the map and rebuild it exactly
        from the store — the in-step stamp clipped those cells, and a
        re-stamp would double-count the in-bounds ones (count cells are not
        idempotent). Rare by construction; counted in diag."""
        bmin, bmax = self._scan_world_bbox(pose, points, mask)
        spec = self.fspec.pub_spec
        off = self._host_pub_off
        extent = np.array([spec.width, spec.height]) * spec.resolution
        if ((bmin + off >= 0).all() and (bmax + off <= extent).all()):
            return
        self._grow_pub_to_bbox(bmin, bmax)
        self.diag.pub_clip_rebuilds += 1
        self._rebuild_pub()

    def _rebuild_pub(self):
        """Rebuild the pub map from every stored scan at its current pose
        (InitMapWithRangeVec on the pub map, slam_processor.cpp:350-366)."""
        cfg = self.config
        pts, msk, poses, valid = self.store.all_arrays()
        self.state.pub = rebuild_count_map(
            self.fspec.pub_spec, self.state.pub.offset, pts, msk, poses,
            valid, cfg.map_update_free_factor, cfg.map_update_occu_factor,
            first_scan_extra=int(cfg.map_min_passthrough))
        self._publish_pub_arrays()

    def _grow_pub_to(self, new_w: int, new_h: int,
                     shift_x_cells: int, shift_y_cells: int):
        """Re-allocate the pub map at (new_h, new_w) on the device, placing
        the old content ``shift`` cells from the new low edge."""
        spec = self.fspec.pub_spec
        old = self.state.pub
        H, W = old.hits.shape
        ys = slice(shift_y_cells, shift_y_cells + H)
        xs = slice(shift_x_cells, shift_x_cells + W)
        hits = torch.zeros((new_h, new_w), dtype=torch.float32, device=self.device)
        passes = torch.zeros((new_h, new_w), dtype=torch.float32, device=self.device)
        hits[ys, xs] = old.hits
        passes[ys, xs] = old.passes
        new_off = (self._host_pub_off
                   + np.array([shift_x_cells, shift_y_cells]) * spec.resolution)
        self._host_pub_off = new_off
        new_spec = dataclasses.replace(spec, height=new_h, width=new_w)
        self.fspec = dataclasses.replace(self.fspec, pub_spec=new_spec)
        self.bspec = dataclasses.replace(self.bspec, pub_spec=new_spec)
        self.backend.spec = self.bspec
        self.state.pub = CountMap(
            hits, passes,
            torch.as_tensor(new_off, dtype=torch.float32, device=self.device))
        self._publish_pub_arrays()

    def finish(self):
        """Flush pending back-end work. NOT terminal: further process()
        calls continue the run."""
        self.process_backend()

    # ---- corrections (CorrectPoseAndMap, slam_processor.cpp:329-370) ----

    def _apply_corrections(self, corrected: np.ndarray):
        n_corr = corrected.shape[0]
        n = len(self.store)
        if n_corr == 0 or n == 0:
            return
        for sid in range(min(n_corr, n)):
            self.store.set_pose(sid, corrected[sid])
        # corrections move poses arbitrarily (a loop closure can swing the
        # whole trailing trajectory); grow the pub map to the corrected
        # scans' union bbox BEFORE the rebuild so no stamp clips
        bbox = self.store.scans_world_bbox()
        if bbox is not None:
            self._grow_pub_to_bbox(bbox[0], bbox[1])
        pts, msk, poses, valid = self.store.all_arrays()
        cfg = self.config
        st = self.state
        st.pub, st.coarse, st.fine = _rebuild_all_maps(
            self.fspec.pub_spec, self.fspec.coarse_spec, self.fspec.fine_spec,
            st.pub.offset, st.coarse.offset, st.fine.offset,
            pts, msk, poses, valid,
            cfg.map_update_free_factor, cfg.map_update_occu_factor,
            int(cfg.map_min_passthrough), bool(cfg.coarse_map_use_blur),
            bool(cfg.fine_map_use_blur))
        # carry the corrected latest pose forward (deviation from the
        # reference, which leaves current_sensor_pose_ stale; carrying the
        # correction is strictly more robust). Mirror through float32 so the
        # host copy equals the device value.
        self._host_pose = np.asarray(self.store.poses[-1],
                                     np.float32).astype(np.float64)
        new_pose = torch.as_tensor(self.store.poses[-1], dtype=torch.float32,
                                   device=self.device)
        st.pose = new_pose
        st.last_map_update_pose = new_pose.clone()
        for i, (t, _) in enumerate(self.trajectory):
            self.trajectory[i] = (t, self.store.poses[i].copy())
        self._publish_pub_arrays()

    # ---- outputs ----

    def run_log(self, log, progress: bool = False) -> np.ndarray:
        """Replay a scan log (any object with ``ranges``, ``odom``, ``times``
        arrays and ``len``); returns the estimated trajectory (N_kept, 4):
        t, x, y, theta."""
        for i in range(len(log)):
            self.process(log.ranges[i], log.odom[i], float(log.times[i]))
            if progress and i % 50 == 0:
                print(f"  scan {i}/{len(log)} kept={len(self.store)} "
                      f"loops={self.backend.num_loop_closures}")
        self.finish()
        return self.trajectory_array()

    def trajectory_array(self) -> np.ndarray:
        return np.array([[t, p[0], p[1], p[2]] for t, p in self.trajectory])

    def get_pub_map(self) -> np.ndarray:
        """Published occupancy grid: -1 unknown / 0 free / 100 occupied
        (PublishMapThread, roborts_slam_node.cpp:427-469)."""
        cfg = self.config
        return count_map_states(self.state.pub, cfg.map_min_passthrough,
                                cfg.map_occu_threshold).cpu().numpy()

    def force_graph_optimize(self):
        self.backend.force_optimize()
