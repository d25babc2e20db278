"""SlamEngine — the top-level SLAM loop, as the check runs it.

Counterpart of the JAX package's ``engine.py`` (``SlamNode`` +
``SlamProcessor`` orchestration, src/roborts_slam_node.cpp,
src/slam/slam_processor.cpp): consumes a scan stream scan by scan, runs the
front-end step, maintains the scan store (the reference's
SensorDataManager), and drives the back end (pose graph + loop closure)
synchronously after every kept scan.

A frozen copy of the program's synchronous, eager path, with the options of
the configurations (the windowed match, the rolling match-map window,
odometry de-distortion on ingest, the branch-and-bound and optimizer coarse
stages) and the fused front-end+chain step: the chains the back end will
match for a scan are predicted on the host before its step, and their chain
batch, the store append and the step run with one host read. Each step's
inputs go to the device as one staged float32 vector (``staging.py``), as
the program's replayed steps take them; every operation launches eagerly.
All device state lives on one explicit ``device``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from fractions import Fraction

import numpy as np
import torch

from .config import SlamConfig
from .backend.pose_graph import PoseGraph, solver_bucket
from .backend.processor import Backend, BackendSpec, fused_frontend_chain_step
from .frontend.processor import (
    FrontendSpec, FrontendState, frontend_step, frontend_step_windowed,
    init_frontend_state,
)
from .io.dedistort import dedistort_scan
from .models.scan import LaserModel, pack_points, ranges_to_packed
from .models.grid_map import CountMap, ProbMap, make_prob_map
from .ops.raster import rebuild_count_map, stamp_scan_batch
from .staging import stage, staged_size, unstage


def _stamp_match_maps(coarse_spec, fine_spec, coarse_off, fine_off,
                      pts, msk, poses, valid, coarse_blur: bool,
                      fine_blur: bool):
    """Fresh coarse+fine match maps stamped from a scan batch (the
    correction rebuild and the rolling-window recenter)."""
    def fresh(spec, off):
        return make_prob_map(spec, off, pts.device)

    if pts.shape[0] == 0:       # no scan in reach: both maps stay unknown
        return fresh(coarse_spec, coarse_off), fresh(fine_spec, fine_off)
    coarse = stamp_scan_batch(coarse_spec, fresh(coarse_spec, coarse_off),
                              pts, msk, poses, valid, use_blur=coarse_blur)
    fine = stamp_scan_batch(fine_spec, fresh(fine_spec, fine_off),
                            pts, msk, poses, valid, use_blur=fine_blur)
    return coarse, fine


def _rebuild_all_maps(pub_spec, coarse_spec, fine_spec, pub: CountMap,
                      coarse: ProbMap, fine: ProbMap, pts, msk, poses, valid,
                      free_f, occu_f, first_scan_extra: int, coarse_blur: bool,
                      fine_blur: bool):
    """The full CorrectPoseAndMap rebuild (pub + coarse + fine,
    slam_processor.cpp:350-366) from every stored scan, written into the
    three maps' planes in place: the pub planes zeroed and carved one batch
    slot at a time, the match maps reset to unknown and stamped. ``valid``
    masks the padding slots of a batch padded to JAX's bucket, which change
    no bit of any map."""
    rebuild_count_map(pub_spec, pub.offset, pts, msk, poses, valid, free_f, occu_f,
                      first_scan_extra=first_scan_extra, out=pub)
    for spec, pmap, blur in ((coarse_spec, coarse, coarse_blur),
                             (fine_spec, fine, fine_blur)):
        pmap.probs.fill_(spec.default_prob)
        stamp_scan_batch(spec, pmap, pts, msk, poses, valid, use_blur=blur)


def _upload(dst: torch.Tensor, src: np.ndarray):
    """Copy host rows into the device rows ``dst`` without waiting for the
    device: through pinned memory on the card (a copy from pageable memory
    synchronises), which the host allocator keeps until the copy has run."""
    host = torch.from_numpy(np.ascontiguousarray(src))
    if dst.is_cuda:
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)


class ScanStore:
    """Append-only store of accepted scans (SensorDataManager,
    src/slam/sensor_data_manager.h:349-595). One copy per scan in
    sensor-local meters on the host, plus a device mirror: plain
    preallocated tensors (capacity doubling) written in place, which the
    back end's chain matches gather from by id."""

    _DEV_CAP_START = 256

    def __init__(self, max_points: int, device,
                 running_range_max_scans: int = 70,
                 running_range_max_distance: float = 5.0):
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
        # running-range sliding window (UpdateRunningRange,
        # sensor_data_manager.h:540-558): most recent scan ids bounded by
        # count and by span of their sensor x/y positions
        self.running_range_max_scans = running_range_max_scans
        self.running_range_max_distance = running_range_max_distance
        self.running_ids: list[int] = []
        # device mirror
        self._dev_points = None
        self._dev_masks = None
        self._dev_poses = None
        self._dev_cap = 0
        self._dev_count = 0
        self._dev_poses_stale = True
        # bumped by every set_pose: fused chain rows computed before a pose
        # moved were matched on maps stamped from the old poses
        self.pose_version = 0

    def __len__(self):
        return len(self._points)

    def n_valid(self, scan_id: int) -> int:
        return self._n_valid[scan_id]

    def add(self, points: np.ndarray, mask: np.ndarray, n_valid: int,
            pose: np.ndarray, odom: np.ndarray, t: float,
            dev_row: bool = False) -> int:
        """Append a kept scan; returns its id. ``dev_row``: a fused or
        pipelined step already wrote the scan's device row at this id, so the
        mirror counts it instead of uploading it again (the counterpart of
        the JAX store's ``absorb_fused_append``)."""
        # defensive copies: callers may reuse their scan buffers between
        # calls; the store owns its data
        points = np.array(points, np.float32, copy=True)
        mask = np.array(mask, bool, copy=True)
        w = mask.astype(np.float64)
        centroid = (points * w[:, None]).sum(0) / max(w.sum(), 1.0)
        # sensor-local endpoint bbox, cached for O(scans) world-bbox
        # queries after pose corrections (4-corner transform per scan)
        pv = points[mask]
        bbox = ((pv.min(0), pv.max(0)) if len(pv)
                else (np.zeros(2, np.float32), np.zeros(2, np.float32)))
        self._points.append(points)
        self._masks.append(mask)
        self._n_valid.append(int(n_valid))
        self._centroids.append(centroid)
        self._local_bboxes.append(bbox)
        self.poses.append(np.asarray(pose, np.float64).copy())
        self.odoms.append(np.asarray(odom, np.float64).copy())
        self.times.append(float(t))
        sid = len(self._points) - 1
        if sid >= self._bary.shape[0]:
            grown = np.zeros((2 * self._bary.shape[0], 3), np.float64)
            grown[:self._bary.shape[0]] = self._bary
            self._bary = grown
        self._update_running_range(sid)
        if dev_row and self._dev_points is not None and self._dev_count == sid:
            self._dev_count = sid + 1
        return sid

    def _update_running_range(self, scan_id: int):
        """Sliding window over recent scans (UpdateRunningRange,
        sensor_data_manager.h:540-558): cap the id count, then shrink from
        the front while the window's sensor-position span exceeds the
        distance bound."""
        self.running_ids.append(scan_id)
        while len(self.running_ids) > self.running_range_max_scans:
            self.running_ids.pop(0)

        def span_exceeds():
            ps = np.asarray([self.poses[i][:2] for i in self.running_ids])
            return (ps.max(0) - ps.min(0)).max() > self.running_range_max_distance

        while len(self.running_ids) > 1 and span_exceeds():
            self.running_ids.pop(0)

    def set_pose(self, scan_id: int, pose: np.ndarray):
        self.poses[scan_id] = np.asarray(pose, np.float64).copy()
        self._bary_dirty_from = min(self._bary_dirty_from, scan_id)
        self._dev_poses_stale = True
        self.pose_version += 1

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
        return self._bary[:n].copy()

    def pub_map_arrays(self):
        """``(pub_spec, hits, passes, offset)`` as the engine last published
        them: the live state tensors."""
        return self._pub_arrays

    def device_arrays(self, reserve: int = 0):
        """Device-resident ``(points (cap,P,2), masks (cap,P), poses
        (cap,3))`` of every stored scan. Capacity doubles (one re-upload per
        doubling); otherwise each new scan is one in-place row write. Poses
        re-upload whole (tiny) only after ``set_pose`` invalidated them.
        ``reserve``: rows past the stored ones that the caller's step will
        write on the device; the capacity grows before they are handed out."""
        n = len(self)
        dev = self.device
        if self._dev_points is None or n + reserve > self._dev_cap:
            cap = self._DEV_CAP_START
            while cap < n + reserve:
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
        lo = self._dev_count
        if lo < n:
            _upload(self._dev_points[lo:n], np.stack(self._points[lo:n]))
            _upload(self._dev_masks[lo:n], np.stack(self._masks[lo:n]))
            _upload(self._dev_poses[lo:n],
                    np.asarray(self.poses[lo:n], np.float32))
            self._dev_count = n
        if self._dev_poses_stale and n:
            _upload(self._dev_poses[:n], self.poses_array().astype(np.float32))
        self._dev_poses_stale = False
        return self._dev_points, self._dev_masks, self._dev_poses

    def gather(self, ids):
        """Device tensors ``(points (n,P,2), masks (n,P), poses (n,3), valid
        (n,))`` of the scans ``ids``, gathered on the device from the mirror
        by one id vector (no padding: exactly the ids asked for)."""
        pts, msk, poses = self.device_arrays()
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        valid = torch.ones((len(idx),), dtype=torch.bool, device=self.device)
        return pts[idx], msk[idx], poses[idx], valid

    def running_range_arrays(self):
        """Device tensors of the running-range window scans, the input the
        windowed front-end step takes. The reference defines the
        windowed-match path but ships it disabled (kUseRunningRangeScanMatch
        = false, slam_processor.h:265)."""
        return self.gather(self.running_ids)

    def all_arrays(self, bucket: int | None = None):
        """Every stored scan as device tensors ``(points (B,P,2), masks
        (B,P), poses (B,3), valid (B,))`` padded as the JAX package's
        ``all_arrays`` pads them, to ``B = 64·2^k >= n`` (or ``bucket``;
        ``len(store)``: the exact rows): views of the device mirror's first
        B rows (its capacity, ``256·2^j >= n``, holds the bucket) with
        ``valid`` false past the stored scans."""
        pts, msk, poses = self.device_arrays()
        n = len(self)
        b = solver_bucket(n) if bucket is None else bucket
        if b > self._dev_cap:
            raise ValueError(f"all_arrays: bucket {b} past the mirror's "
                             f"{self._dev_cap} rows")
        valid = torch.arange(b, device=self.device) < n
        return pts[:b], msk[:b], poses[:b], valid


@dataclasses.dataclass
class EngineDiagnostics:
    scans_in: int = 0
    scans_processed: int = 0
    scans_dropped_gate: int = 0
    scans_dropped_move: int = 0
    loop_closures: int = 0
    pub_clip_rebuilds: int = 0     # post-match growth events (_ensure_pub_covers)
    scans_dedistorted: int = 0     # scans through the de-distortion ingest branch
    recenters: int = 0             # rolling match-map window rebuilds
    fused_steps: int = 0           # front-end steps that carried a chain batch


class SlamEngine:
    """Online SLAM over a scan stream."""

    def __init__(self, config: SlamConfig, laser: LaserModel,
                 world_size: float | None = None, device=None):
        self.device = torch.device(device)
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
        # fetch, on growth/recenter and on corrections.
        self._host_pose = np.zeros(3)
        self._host_fine_off = self.state.fine.offset.cpu().numpy().astype(np.float64)
        self._host_coarse_off = self.state.coarse.offset.cpu().numpy().astype(np.float64)
        self._host_pub_off = self.state.pub.offset.cpu().numpy().astype(np.float64)
        self.store = ScanStore(
            config.max_points, self.device,
            running_range_max_scans=config.running_range_size,
            running_range_max_distance=config.running_range_max_distance)
        self.backend = Backend(self.bspec, self.store)
        self.backend.on_corrections = self._apply_corrections
        self.diag = EngineDiagnostics()
        self._bounds_warned = False
        self.trajectory: list[tuple[float, np.ndarray]] = []  # (t, pose) per kept scan
        self._last_kept_odom: np.ndarray | None = None
        # the move gate's reference: the last kept odometry
        self._move_ref_odom: np.ndarray | None = None
        self._last_process_time: float | None = None
        self._prev_process_time: float | None = None
        # times shipped to the device are seconds since this stamp, taken in
        # float64 on the host (f32 holds no epoch stamp to the second)
        self._dev_time_origin: float | None = None
        self._odom_history: list[tuple[float, np.ndarray]] = []
        self._pending_backend: list[tuple] = []   # (scan_id, cov, prematched)
        self.backend.diag = self.diag
        # the packed summary of the latest step, as read (float64)
        self.last_summary: np.ndarray | None = None

    # ---- gates (MoveEnough, slam_processor.cpp:604-616) ----

    def _publish_pub_arrays(self):
        """Install the feedback pub-map arrays the back end reads
        (ScanStore.pub_map_arrays), paired with their spec: the live state
        tensors."""
        pub = self.state.pub
        self.store._pub_arrays = (self.fspec.pub_spec, pub.hits, pub.passes, pub.offset)

    def _move_enough(self, odom: np.ndarray, t: float) -> bool:
        cfg = self.config
        if not cfg.use_odometry or not cfg.use_move_check:
            return True
        ref = (self._move_ref_odom if self._move_ref_odom is not None
               else self._last_kept_odom)
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
        if (self.config.use_odom_correct and self.laser.scan_time > 0
                and len(self._odom_history) >= 2):
            points, mask, n_valid = self._dedistorted_points(ranges, t)
        else:
            points, mask, n_valid = ranges_to_packed(
                ranges, self.laser, self.config.max_points)
        return self._process_gated(points, mask, n_valid, odom, t)

    def _dedistorted_points(self, ranges: np.ndarray, t: float):
        """Odometry-based sweep de-distortion (LaserDataProcessor,
        laser_data_processor.cpp:43-314) on the ingest path: re-project each
        beam into the sweep-END frame (scans are stamped, and odometry
        paired, at time ``t`` = end of sweep), then gate and front-pack like
        ``ranges_to_packed``."""
        ranges = np.asarray(ranges, np.float32)
        # the reference also drops beams beyond range_threshold
        # (roborts_slam_node.cpp:295-307); mark them invalid pre-correction
        gated = np.where(ranges < self.laser.range_threshold, ranges, 0.0)
        ot = np.array([h[0] for h in self._odom_history])
        op = np.stack([h[1] for h in self._odom_history])
        pts = dedistort_scan(gated, self.laser, t - self.laser.scan_time,
                             self.laser.scan_time, ot, op, reference="end")
        packed = pack_points(pts[~np.isnan(pts[:, 0])], self.config.max_points)
        self.diag.scans_dedistorted += 1
        return packed

    def _pass_move_gate(self, odom: np.ndarray, t: float) -> bool:
        """Record the odometry sample (de-distortion reads the history),
        then gate."""
        self._odom_history.append((t, np.asarray(odom, np.float64).copy()))
        if len(self._odom_history) > 64:
            self._odom_history.pop(0)
        if self._dev_time_origin is None:
            self._dev_time_origin = float(t)
        self.diag.scans_in += 1
        if self._move_enough(np.asarray(odom, np.float64), t):
            return True
        self.diag.scans_dropped_move += 1
        return False

    def _process_gated(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Run the front-end step on an already-gated, already-converted
        scan, then the bookkeeping of a kept scan (store, trajectory) and the
        back end."""
        self._prev_process_time = self._last_process_time
        self._last_process_time = t
        np_points = np.asarray(points, np.float32)
        np_mask = np.asarray(mask, bool)
        odom = np.asarray(odom, np.float64)
        dev = self.device
        windowed = self.config.use_running_range_scan_match and len(self.store) > 0
        # grow the pub map BEFORE the step so this scan lands unclipped
        # (UpdateBound runs inside UpdateMapByRange in the reference,
        # grid_map_base.h:257-274); the predicted pose is within the
        # search window of the matched pose
        self._maybe_grow_pub(self._predict_pose_host(odom), np_points,
                             np_mask)
        fused_in = None
        if not self.config.use_running_range_scan_match and len(self.store) > 0:
            fused_in = self._prepare_fused(
                *self._predict_chains(np_points, np_mask, odom))
        if windowed:
            # windowed match path (slam_processor.cpp:134-159): the
            # running-range window scans are the match map source,
            # gathered on the device from the store mirror by id
            scan = (torch.as_tensor(np_points, device=dev),
                    torch.as_tensor(np_mask, device=dev), int(n_valid),
                    torch.as_tensor(odom, dtype=torch.float32, device=dev))
            self.state, info = frontend_step_windowed(
                self.fspec, self.state, *self.store.running_range_arrays(), *scan)
            s = info.summary
        else:
            s = self._blocking_step(np_points, np_mask, int(n_valid), odom, t, fused_in)
        self.last_summary = s
        # the step read ONE packed vector — pose + cov + gates, and the
        # chain rows of a fused step
        accepted = bool(s[12] > 0.5)
        pose = s[:3].copy()
        cov = s[3:12].reshape(3, 3).copy()
        # summary's pose IS the new state.pose, so the mirror updates
        # unconditionally
        self._host_pose = pose.copy()
        self._publish_pub_arrays()

        if not accepted:
            self.diag.scans_dropped_gate += 1
            return False

        self.diag.scans_processed += 1
        if self.config.match_map_window > 0:
            self._maybe_recenter(pose)
        else:
            self._check_world_bounds(pose)
        self._last_kept_odom = odom.copy()
        self._move_ref_odom = self._last_kept_odom
        scan_id = self.store.add(np_points, np_mask, n_valid, pose, odom, t,
                                 dev_row=fused_in is not None)
        self.trajectory.append((t, pose))
        self._ensure_pub_covers(pose, np_points, np_mask)

        prematched = self._prematched(fused_in, s[15:])
        self._pending_backend.append((scan_id, cov, prematched))
        self.process_backend()
        return True

    # ---- the per-scan step (JAX's jitted step) ----

    def _stage_scan(self, np_points, np_mask, n_valid: int, odom, t: float, ids,
                    slot: int) -> torch.Tensor:
        """Everything a step sends to the device, as one float32 vector
        (``staging.stage``: the scan, ``n_valid``, odometry, the time since
        the first stamp, the store slot, the chain ids), on the host."""
        size = staged_size(np_points.shape[0], None if ids is None else ids.shape)
        host = torch.empty((size,), dtype=torch.float32)
        stage(host.numpy(), np_points, np_mask, n_valid, odom,
              t - self._dev_time_origin, slot, False, ids)
        return host

    def _run_step(self, host: torch.Tensor, P: int, ids_shape) -> torch.Tensor:
        """The step on the staged ``host`` vector (a scan of ``P`` points),
        copied to the device: the blocking step, or the fused one with the
        chain batch of the ids' shape ``ids_shape``. Returns its packed output
        on the device, read nothing."""
        st, fspec, bspec = self.state, self.fspec, self.bspec
        staged = torch.zeros((host.shape[0],), dtype=torch.float32, device=self.device)
        staged.copy_(host)
        d = unstage(staged, P, ids_shape)
        if ids_shape is None:
            _, info = frontend_step(fspec, st, d["points"], d["mask"], d["n_valid"],
                                    d["odom"], device_gate=True)
            return info.packed
        rows = (self.store._dev_points, self.store._dev_masks, self.store._dev_poses)
        return fused_frontend_chain_step(fspec, bspec, st, d["points"], d["mask"],
                                         d["n_valid"], d["odom"], *rows, d["ids"],
                                         d["slot"])[2]

    def _blocking_step(self, np_points, np_mask, n_valid: int, odom, t: float,
                       fused_in) -> np.ndarray:
        """One blocking front-end step — the fused one (chain batch and store
        row on the device) where ``fused_in`` is given — and its one host
        read: the packed summary (float64)."""
        ids, slot = None, 0
        if fused_in is not None:
            self.store.device_arrays(reserve=1)
            slot = self.store._dev_count
            ids = fused_in["ids"]
            self.diag.fused_steps += 1
        host = self._stage_scan(np_points, np_mask, n_valid, odom, t, ids, slot)
        packed = self._run_step(host, np_points.shape[0], None if ids is None else ids.shape)
        return packed.cpu().numpy().astype(np.float64)

    def _install_maps(self, pub=None, coarse=None, fine=None):
        """Write rebuilt maps into the state's own buffers; a map whose shape
        changed (the pub map grew) takes its new buffers."""
        st = self.state
        for name, new in (("pub", pub), ("coarse", coarse), ("fine", fine)):
            if new is None:
                continue
            old = getattr(st, name)
            if all(o.shape == n.shape for o, n in zip(old, new)):
                for o, n in zip(old, new):
                    if o is not n:
                        o.copy_(n)
            else:
                setattr(st, name, new)

    # ---- the fused step's chain rows (JAX engine.py:1084-1168) ----

    @staticmethod
    def _bary_of_pose(pose: np.ndarray, np_points: np.ndarray,
                      np_mask: np.ndarray) -> np.ndarray:
        """The barycenter a scan will have at ``pose`` (ScanStore's rule)."""
        w = np_mask.astype(np.float64)
        cent = (np_points.astype(np.float64) * w[:, None]).sum(0) / max(w.sum(), 1.0)
        c, s = np.cos(pose[2]), np.sin(pose[2])
        return np.array([pose[0] + c * cent[0] - s * cent[1],
                         pose[1] + s * cent[0] + c * cent[1], pose[2]])

    def _predict_chains(self, np_points: np.ndarray, np_mask: np.ndarray,
                        odom: np.ndarray):
        """The chain sets this scan's back-end pass will match, predicted
        before its step: LinkNearChains' near chains and TryCloseLoop's
        first-round loop candidates, from the odometry-predicted pose and
        this scan's centroid. Returns ``(near, loop)``."""
        pred = self._predict_pose_host(odom)
        newbary = self._bary_of_pose(pred, np_points, np_mask)
        stored = self.store.barycenters()
        bary = np.concatenate([stored, newbary[None]])
        graph = self.backend.graph
        k = len(stored) - graph.num_vertices + 1
        near = [ch for ch in graph.find_near_chains_for_new(bary, k=k)
                if len(ch) >= self.config.loop_match_min_chain_size]
        return near, graph.find_all_loop_candidates_for_new(bary, k=k)

    def _prepare_fused(self, near: list, loop: list):
        """The chain batch of a fused step from the predicted ``near`` and
        ``loop`` chain sets (both take the matched pose as init and centre,
        so their coarse matches are one batch). Returns ``{"near", "loop", "ids" (bucket, K) int64
        array, "pose_version"}``, or None where nothing is predicted or the
        near chains do not fit one batch (that step is unfused)."""
        if not (near or loop):
            return None       # (before the batch limit, which reads the card)
        step = self.backend.chain_step(fused=True)
        if len(near) + len(loop) > step:
            loop = []         # loop rows are opportunistic; drop them first
        if len(near) > step:
            return None
        K = self.bspec.max_chain_scans
        rows = [PoseGraph.sparsify_chain(ch) for ch in near] + loop
        bucket = next(b for b in self.backend._BATCH_BUCKETS if b >= len(rows))
        ids = np.full((bucket, K), -1, np.int64)
        for b, chain in enumerate(rows):
            ids[b, :min(len(chain), K)] = chain[:K]
        return {"near": near, "loop": loop, "ids": ids,
                "pose_version": self.store.pose_version}

    @staticmethod
    def _prematched(fused_in, rows: np.ndarray):
        """The fused step's chain rows (pose(3) + score(1) + cov(9) each)
        paired with the chain sets they were matched for."""
        if fused_in is None:
            return None
        flat = rows.reshape(-1, 13)
        out = [(flat[i, :3].copy(), float(flat[i, 3]), flat[i, 4:13].reshape(3, 3).copy())
               for i in range(len(fused_in["near"]) + len(fused_in["loop"]))]
        nn = len(fused_in["near"])
        return {"near": (fused_in["near"], out[:nn]) if fused_in["near"] else None,
                "loop": (fused_in["loop"], out[nn:]) if fused_in["loop"] else None,
                "pose_version": fused_in["pose_version"]}

    def _fresh_prematched(self, pre):
        """Drop fused rows matched on maps stamped from since-corrected poses
        (the store's ``pose_version`` moved): the consumer then matches
        again against fresh maps. A drop counts as a fused miss."""
        if pre is None:
            return None
        if pre["pose_version"] != self.store.pose_version:
            self.backend.num_fused_misses += 1
            return None
        return pre

    def process_backend(self):
        """Drain the back-end buffer (BackEndProcessThread,
        slam_processor.cpp:384-426): graph updates for every pending scan,
        then one loop-closure attempt at the newest."""
        if not self._pending_backend:
            return
        batch, self._pending_backend = self._pending_backend, []
        self._backend_pass(batch)

    def _backend_pass(self, batch: list[tuple]):
        """One back-end pass over queued ``(scan_id, cov, prematched)`` items:
        a graph update for each, then one loop-closure attempt at the last."""
        for sid, cov, pre in batch:
            pre = self._fresh_prematched(pre)
            self.backend.update_graph(sid, cov, prematched=(pre or {}).get("near"))
        pre = self._fresh_prematched(batch[-1][2])
        self.backend.try_close_loop(batch[-1][0], prematched=(pre or {}).get("loop"))
        self.diag.loop_closures = self.backend.num_loop_closures

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
        pts, msk, poses, valid = self.store.all_arrays(len(self.store))
        self._install_maps(pub=rebuild_count_map(
            self.fspec.pub_spec, self.state.pub.offset, pts, msk, poses,
            valid, cfg.map_update_free_factor, cfg.map_update_occu_factor,
            first_scan_extra=int(cfg.map_min_passthrough)))
        self._publish_pub_arrays()

    def _grow_pub_to(self, new_w: int, new_h: int,
                     shift_x_cells: int, shift_y_cells: int):
        """Re-allocate the pub map at (new_h, new_w) on the device, placing
        the old content ``shift`` cells from the new low edge. Callers hold"""
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

    # ---- rolling match-map window (config.match_map_window) ----

    def _shift_granule(self) -> float:
        """Smallest shift (m) that is an integer cell count in BOTH
        scan-match maps, so one world-space recenter keeps both lattices.
        lcm(a/b, c/d) = lcm(a·d, c·b) / (b·d)."""
        f = Fraction(str(self.config.fine_map_resolution))
        c = Fraction(str(self.config.coarse_map_resolution))
        num = math.lcm(f.numerator * c.denominator, c.numerator * f.denominator)
        return num / (f.denominator * c.denominator)

    def _maybe_recenter(self, pose: np.ndarray):
        """Rolling-window scan-match maps: when the pose drifts beyond a
        quarter window from the window center, re-center the fine+coarse
        maps on it. Newly covered area is NOT left unknown: the maps are
        rebuilt from every stored scan whose beams can reach the new window,
        so revisiting a long-left region matches against real content
        exactly like the reference's ever-growing maps
        (grid_map_base.h:188-274). The pub map keeps the global extent (it
        is the published product)."""
        fs = self.fspec.fine_spec
        extent = np.array([fs.width, fs.height]) * fs.resolution
        center_w = extent * 0.5 - self._host_fine_off
        delta = np.asarray(pose[:2]) - center_w
        window = min(float(extent[0]), float(extent[1]))
        if np.max(np.abs(delta)) <= 0.25 * window:
            return
        g = self._shift_granule()
        shift_m = np.round(delta / g) * g                    # (dx, dy) meters
        self._rebuild_match_maps_at(self._host_fine_off - shift_m,
                                    self._host_coarse_off - shift_m)

    def _rebuild_match_maps_at(self, fine_off: np.ndarray,
                               coarse_off: np.ndarray):
        """Fresh fine+coarse match maps at the given offsets, stamped from
        the stored scans within beam reach of the new window — exactly those
        (the JAX package pads the batch to size buckets only to bound
        recompilation). Keeps the host mirrors of both offsets in step."""
        cfg = self.config
        fs, cs = self.fspec.fine_spec, self.fspec.coarse_spec
        self._host_fine_off = np.asarray(fine_off, np.float64)
        self._host_coarse_off = np.asarray(coarse_off, np.float64)
        extent = np.array([fs.width, fs.height]) * fs.resolution
        center_new = extent * 0.5 - fine_off
        reach = 0.5 * float(extent.max()) + self.laser.range_threshold
        poses = self.store.poses_array()
        ids = []
        if len(poses):
            d = np.abs(poses[:, :2] - center_new[None]).max(1)
            ids = np.flatnonzero(d <= reach)
        f32 = dict(dtype=torch.float32, device=self.device)
        coarse, fine = _stamp_match_maps(
            cs, fs, torch.as_tensor(coarse_off, **f32),
            torch.as_tensor(fine_off, **f32), *self.store.gather(ids),
            bool(cfg.coarse_map_use_blur), bool(cfg.fine_map_use_blur))
        self._install_maps(coarse=coarse, fine=fine)
        self.diag.recenters += 1

    # ---- corrections (CorrectPoseAndMap, slam_processor.cpp:329-370) ----

    def _apply_corrections(self, corrected: np.ndarray):
        """Install the solved poses of the stored scans and rebuild every
        map (the back end calls this)."""
        n_corr = corrected.shape[0]
        if n_corr == 0 or len(self.store) == 0:
            return
        for sid in range(n_corr):
            self.store.set_pose(sid, corrected[sid])
        # corrections move poses arbitrarily (a loop closure can swing the
        # whole trailing trajectory); grow the pub map to the corrected
        # scans' union bbox BEFORE the rebuild so no stamp clips
        bbox = self.store.scans_world_bbox()
        if bbox is not None:
            self._grow_pub_to_bbox(bbox[0], bbox[1])
        self._rebuild_maps()
        st = self.state
        # carry the corrected latest pose forward (deviation from the
        # reference, which leaves current_sensor_pose_ stale; carrying the
        # correction is strictly more robust). Mirror through float32 so the
        # host copy equals the device value.
        self._host_pose = np.asarray(self.store.poses[-1],
                                     np.float32).astype(np.float64)
        new_pose = torch.as_tensor(self.store.poses[-1], dtype=torch.float32,
                                   device=self.device)
        st.pose.copy_(new_pose)
        st.last_map_update_pose.copy_(new_pose)
        for i, (t, _) in enumerate(self.trajectory):
            self.trajectory[i] = (t, self.store.poses[i].copy())
        self._publish_pub_arrays()

    def _rebuild_all(self, pts, msk, poses, valid):
        """``_rebuild_all_maps`` of the given rows into the state's maps."""
        st, fs, cfg = self.state, self.fspec, self.config
        _rebuild_all_maps(fs.pub_spec, fs.coarse_spec, fs.fine_spec, st.pub, st.coarse,
                          st.fine, pts, msk, poses, valid, cfg.map_update_free_factor,
                          cfg.map_update_occu_factor, int(cfg.map_min_passthrough),
                          bool(cfg.coarse_map_use_blur), bool(cfg.fine_map_use_blur))

    def _rebuild_maps(self):
        """Rebuild every map from the stored scans at their current poses,
        from the exact rows."""
        self._rebuild_all(*self.store.all_arrays(len(self.store)))
