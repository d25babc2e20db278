"""SlamEngine — the top-level online SLAM loop.

Counterpart of the JAX package's ``engine.py`` (``SlamNode`` +
``SlamProcessor`` orchestration, src/roborts_slam_node.cpp,
src/slam/slam_processor.cpp): consumes a scan stream scan by scan, runs the
front-end step, maintains the scan store (the reference's
SensorDataManager), and drives the back end (pose graph + loop closure)
either synchronously after every kept scan or on a worker thread (the
reference's BackEndProcessThread, slam_processor.cpp:384-426).

The port carries every option of the two shipped profiles and of the default
configuration (the windowed match, the rolling match-map window, odometry
de-distortion on ingest), the asynchronous back-end worker, the fixed-rate
pose stream (``pose_at``) and the live-output hooks (``on_pose``,
``on_map_snapshot``), and the JAX engine's two modes that cut host reads:

- the fused front-end+chain step (``fused_backend=True``, the default, as in
  the JAX package): the chains the back end will match for a scan are
  predicted on the host before its step, and their chain batch, the store
  append and the step run with one host read;
- the pipelined fetch (``pipelined_fetch = True``, with the synchronous back
  end and without the windowed match): each scan is dispatched without
  waiting for anything of the scans before it (the move gate and the store's
  append cursor run on the device), its summary comes back through pinned
  memory behind an event, and the host's bookkeeping reconciles
  ``pipeline_depth`` scans behind. Events that rewrite maps or read them
  drain the pipeline first.

Two threads share the engine in asynchronous mode. The maps are updated in
place, so the front-end step, map growth, recenters and corrections run
under ``_state_lock``, the scan store takes its own lock round every access,
and the worker reads a clone of the pub map made under the state lock. Both
threads launch on one CUDA stream (the caller's current stream when the
worker starts): stream order then carries the locks' order to the device,
and a tensor that one thread frees is not reused by the allocator before
the other thread's work on it has run.

All device state lives on one explicit ``device``. ``device=None`` means
the card and raises when there is none; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import queue as _queue
import threading
import time as _time
import warnings
from fractions import Fraction

import numpy as np
import torch

from .config import SlamConfig
from .backend.pose_graph import PoseGraph
from .backend.processor import (
    Backend, BackendSpec, fused_cursor_step, fused_frontend_chain_step,
)
from .frontend.processor import (
    FrontendSpec, FrontendState, frontend_step, frontend_step_windowed,
    init_frontend_state,
)
from .io.dedistort import dedistort_scan
from .models.scan import LaserModel, pack_points, ranges_to_packed
from .models.grid_map import CountMap, ProbMap, count_map_states, make_prob_map
from .ops.raster import rebuild_count_map, stamp_scan_batch
from .utils.profiling import StageTimers


def resolve_device(device) -> torch.device:
    """``None`` -> the card (raises without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


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


def _rebuild_all_maps(pub_spec, coarse_spec, fine_spec,
                      pub_off, coarse_off, fine_off,
                      pts, msk, poses, valid, free_f, occu_f,
                      first_scan_extra: int, coarse_blur: bool,
                      fine_blur: bool):
    """The full CorrectPoseAndMap rebuild (pub + coarse + fine,
    slam_processor.cpp:350-366) from every stored scan."""
    pub = rebuild_count_map(pub_spec, pub_off, pts, msk, poses, valid,
                            free_f, occu_f, first_scan_extra=first_scan_extra)
    coarse, fine = _stamp_match_maps(coarse_spec, fine_spec, coarse_off,
                                     fine_off, pts, msk, poses, valid,
                                     coarse_blur, fine_blur)
    return pub, coarse, fine


class ScanStore:
    """Append-only store of accepted scans (SensorDataManager,
    src/slam/sensor_data_manager.h:349-595). One copy per scan in
    sensor-local meters on the host, plus a device mirror: plain
    preallocated tensors (capacity doubling) written in place, which the
    back end's chain matches gather from by id. Every public method holds
    one re-entrant lock: the asynchronous back-end worker corrects poses and
    gathers from the mirror while the front end appends."""

    _DEV_CAP_START = 256

    def __init__(self, max_points: int, device,
                 running_range_max_scans: int = 70,
                 running_range_max_distance: float = 5.0):
        self._lock = threading.RLock()
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
        the JAX store's ``absorb_fused_append`` / cursor sync)."""
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
        with self._lock:
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
        with self._lock:
            self.poses[scan_id] = np.asarray(pose, np.float64).copy()
            self._bary_dirty_from = min(self._bary_dirty_from, scan_id)
            self._dev_poses_stale = True
            self.pose_version += 1

    def poses_array(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self.poses)

    def scans_world_bbox(self):
        """Union world bbox over every stored scan's endpoints (bounded by
        the rotated local bbox corners) plus the sensor positions (carve
        rays start there). O(scans) via the cached local bboxes — used to
        grow the pub map before a correction rebuild so arbitrarily moved
        poses never stamp clipped."""
        with self._lock:
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
        with self._lock:
            n = len(self)
            if self._bary_dirty_from < n:
                ids = range(self._bary_dirty_from, n)
                self._bary[self._bary_dirty_from:n] = self._bary_of(ids)
                self._bary_dirty_from = n
            return self._bary[:n].copy()

    def pub_map_arrays(self):
        """``(pub_spec, hits, passes, offset)`` as the engine last published
        them: the live state tensors in synchronous mode, a clone for the
        asynchronous worker."""
        with self._lock:
            return self._pub_arrays

    def device_arrays(self, reserve: int = 0):
        """Device-resident ``(points (cap,P,2), masks (cap,P), poses
        (cap,3))`` of every stored scan. Capacity doubles (one re-upload per
        doubling); otherwise each new scan is one in-place row write. Poses
        re-upload whole (tiny) only after ``set_pose`` invalidated them.
        ``reserve``: rows past the stored ones that the caller's step will
        write on the device; the capacity grows before they are handed out."""
        with self._lock:
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

    def gather(self, ids):
        """Device tensors ``(points (n,P,2), masks (n,P), poses (n,3), valid
        (n,))`` of the scans ``ids``, gathered on the device from the mirror
        by one id vector (no padding: exactly the ids asked for)."""
        with self._lock:
            pts, msk, poses = self.device_arrays()
            idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
            valid = torch.ones((len(idx),), dtype=torch.bool, device=self.device)
            return pts[idx], msk[idx], poses[idx], valid

    def running_range_arrays(self):
        """Device tensors of the running-range window scans, the input the
        windowed front-end step takes. The reference defines the
        windowed-match path but ships it disabled (kUseRunningRangeScanMatch
        = false, slam_processor.h:265)."""
        with self._lock:
            return self.gather(self.running_ids)

    def all_arrays(self):
        """Every stored scan as device tensors ``(points (n,P,2), masks
        (n,P), poses (n,3), valid (n,))`` — views of the device mirror."""
        with self._lock:
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
    scans_dedistorted: int = 0     # scans through the de-distortion ingest branch
    recenters: int = 0             # rolling match-map window rebuilds
    fused_steps: int = 0           # front-end steps that carried a chain batch
    backend_batches: int = 0       # back-end passes (one loop-closure attempt each)
    backend_batch_max: int = 0     # most kept scans one back-end pass took
    match_time_s: float = 0.0
    backend_time_s: float = 0.0
    dedistort_time_s: float = 0.0  # host clock, inside _dedistorted_points
    recenter_time_s: float = 0.0   # host clock, inside _rebuild_match_maps_at


class SlamEngine:
    """Online SLAM over a scan stream."""

    def __init__(self, config: SlamConfig, laser: LaserModel,
                 world_size: float | None = None,
                 synchronous_backend: bool = True,
                 fused_backend: bool = True,
                 pipelined_fetch: bool = False,
                 device=None):
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
        self.synchronous_backend = synchronous_backend
        # the chain batch of the chains predicted for a scan rides its step
        # (in asynchronous mode the rows travel through the worker's queue)
        self._fused_backend = fused_backend
        self.diag = EngineDiagnostics()
        # host clock per stage, the JAX package's names: frontend_step (the
        # whole step, its summary fetch included), frontend_fetch (that
        # fetch), backend_update, backend_loop_closure (on the worker's
        # thread in asynchronous mode)
        self.timers = StageTimers()
        self._bounds_warned = False
        self.trajectory: list[tuple[float, np.ndarray]] = []  # (t, pose) per kept scan
        self._last_kept_odom: np.ndarray | None = None
        # the move gate's reference: the last kept odometry, or in pipelined
        # mode the newest dispatched scan's (in-flight scans taken as kept)
        self._move_ref_odom: np.ndarray | None = None
        self._last_process_time: float | None = None
        self._prev_process_time: float | None = None
        # times shipped to the device are seconds since this stamp, taken in
        # float64 on the host (f32 holds no epoch stamp to the second)
        self._dev_time_origin: float | None = None
        self._odom_history: list[tuple[float, np.ndarray]] = []
        self._pending_backend: list[tuple] = []   # (scan_id, cov, prematched)
        # map→odom transform (the reference's 100 Hz TF broadcast state,
        # roborts_slam_node.cpp:178-196): pose_at(t) composes it with
        # odometry interpolated at t. Updated per kept scan and per correction.
        self._map_to_odom = np.zeros(3)       # (tx, ty, dtheta)
        # live-output hooks (PublishMapThread / PublishVisualization analogs,
        # roborts_slam_node.cpp:355-488), called on the thread that called
        # process: on_pose(t, pose) per kept scan; on_map_snapshot(n, grid)
        # every map_snapshot_every kept scans with the occupancy grid
        self.on_pose = None
        self.on_map_snapshot = None
        self.map_snapshot_every: int = 0      # 0 = disabled
        # held across the front-end step, map growth, recenters and
        # corrections (re-entrant: the step grows and recenters inside it)
        self._state_lock = threading.RLock()
        # pipelined fetch (attributes, as the JAX package's tests set them):
        # up to ``pipeline_depth`` scans in flight, each entry owning its
        # pinned buffers until its event has passed
        self.pipelined_fetch = pipelined_fetch
        self.pipeline_depth = 3
        self._inflight: list[dict] = []
        self._dev_cursor = None               # (1,) int64: the next store row
        self._pipe_bucket: int | None = None  # the pipeline's fixed chain bucket
        self._pipe_seeded = False             # device move-gate time seeded
        # asynchronous back end (BackEndProcessThread,
        # slam_processor.cpp:384-426): items (scan_id, cov, prematched); the
        # worker starts at the first kept scan and again after finish()
        self._backend_queue = (_queue.SimpleQueue()
                               if not synchronous_backend else None)
        self._backend_thread: threading.Thread | None = None
        self._backend_error: BaseException | None = None

    # ---- gates (MoveEnough, slam_processor.cpp:604-616) ----

    def _publish_pub_arrays(self):
        """Install the feedback pub-map arrays the back end reads
        (ScanStore.pub_map_arrays), paired with their spec. Synchronous mode
        hands out the live state tensors. Asynchronous mode hands the worker
        a clone: the front end's next step carves the live maps in place
        while a chain match's map check may still read them. Callers hold
        the state lock, so the clone is queued on the stream before any
        later carve."""
        pub = self.state.pub
        if self.synchronous_backend:
            arrs = (pub.hits, pub.passes, pub.offset)
        else:
            arrs = (pub.hits.clone(), pub.passes.clone(), pub.offset.clone())
        self.store._pub_arrays = (self.fspec.pub_spec, *arrs)

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
        """Feed one scan (raw ranges); returns True if accepted. Raises the
        asynchronous worker's exception if it has failed."""
        self._raise_backend_error()
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
        t0 = _time.perf_counter()
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
        self.diag.dedistort_time_s += _time.perf_counter() - t0
        return packed

    def process_points(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Feed one pre-converted scan (sensor-local cartesian points,
        front-packed mask) — the native RSLG stream's ingest path."""
        self._raise_backend_error()
        if not self._pass_move_gate(odom, t):
            return False
        return self._process_gated(points, mask, n_valid, odom, t)

    def _pass_move_gate(self, odom: np.ndarray, t: float) -> bool:
        """Record the odometry sample (de-distortion and ``pose_at`` read
        the history; the JAX package records it on the ranges path only, so
        its native stream serves no pose between kept scans), then gate. In
        pipelined mode the gate is optimistic (against the newest dispatched
        scan, taken as kept) and the step's own gate on the device, against
        the exact last kept odometry, drops what it lets through wrongly."""
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

    def _pipelined(self) -> bool:
        """Whether the next scan goes through the pipelined step: asked for,
        with the synchronous back end, without the windowed match, and after
        the first kept scan (JAX ``engine.py:661-663,696-698``)."""
        return (self.pipelined_fetch and self.synchronous_backend
                and not self.config.use_running_range_scan_match
                and len(self.store) > 0)

    def _process_gated(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Run the front-end step on an already-gated, already-converted
        scan (both ingest paths funnel here). The step and the bookkeeping of
        a kept scan (store, trajectory, map→odom) are one critical section
        against corrections from the asynchronous worker."""
        self._prev_process_time = self._last_process_time
        self._last_process_time = t
        np_points = np.asarray(points, np.float32)
        np_mask = np.asarray(mask, bool)
        odom = np.asarray(odom, np.float64)
        if self._pipelined():
            return self._process_pipelined(np_points, np_mask, int(n_valid), odom, t)
        dev = self.device
        windowed = self.config.use_running_range_scan_match and len(self.store) > 0
        with self._state_lock:
            # grow the pub map BEFORE the step so this scan lands unclipped
            # (UpdateBound runs inside UpdateMapByRange in the reference,
            # grid_map_base.h:257-274); the predicted pose is within the
            # search window of the matched pose
            self._maybe_grow_pub(self._predict_pose_host(odom), np_points,
                                 np_mask)
            fused_in = None
            if (self._fused_backend and not self.config.use_running_range_scan_match
                    and len(self.store) > 0):
                fused_in = self._prepare_fused(
                    *self._predict_chains(np_points, np_mask, odom))
            t0 = _time.perf_counter()
            scan = (torch.as_tensor(np_points, device=dev),
                    torch.as_tensor(np_mask, device=dev), int(n_valid),
                    torch.as_tensor(odom, dtype=torch.float32, device=dev))
            with self.timers.stage("frontend_step"):
                if windowed:
                    # windowed match path (slam_processor.cpp:134-159): the
                    # running-range window scans are the match map source,
                    # gathered on the device from the store mirror by id
                    self.state, info = frontend_step_windowed(
                        self.fspec, self.state,
                        *self.store.running_range_arrays(), *scan,
                        timers=self.timers)
                    s = info.summary
                elif fused_in is not None:
                    with self.store._lock:
                        rows = self.store.device_arrays(reserve=1)
                        slot = self.store._dev_count
                    self.state, _, s = fused_frontend_chain_step(
                        self.fspec, self.bspec, self.state, *scan, *rows,
                        torch.as_tensor(fused_in["ids"], device=dev), slot,
                        timers=self.timers)
                    self.diag.fused_steps += 1
                else:
                    self.state, info = frontend_step(
                        self.fspec, self.state, *scan, timers=self.timers)
                    s = info.summary
            # the step read ONE packed vector — pose + cov + gates, and the
            # chain rows of a fused step
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
            if self.config.match_map_window > 0:
                self._maybe_recenter(pose)
            else:
                self._check_world_bounds(pose)
            self._last_kept_odom = odom.copy()
            self._move_ref_odom = self._last_kept_odom
            scan_id = self.store.add(np_points, np_mask, n_valid, pose, odom, t,
                                     dev_row=fused_in is not None)
            self.trajectory.append((t, pose))
            self._update_map_to_odom(pose, odom)
        if self.on_pose is not None:
            self.on_pose(t, pose.copy())
        if (self.map_snapshot_every > 0 and self.on_map_snapshot is not None
                and len(self.store) % self.map_snapshot_every == 0):
            self.on_map_snapshot(len(self.store), self.get_pub_map())
        self._ensure_pub_covers(pose, np_points, np_mask)

        prematched = self._prematched(fused_in, s[15:])
        if self.synchronous_backend:
            self._pending_backend.append((scan_id, cov, prematched))
            self.process_backend()
        else:
            self._ensure_backend_thread()
            self._backend_queue.put((scan_id, cov, prematched))
        return True

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
                        odom: np.ndarray, pending: list | None = None):
        """The chain sets this scan's back-end pass will match, predicted
        before its step: LinkNearChains' near chains and TryCloseLoop's
        first-round loop candidates, from the odometry-predicted pose and
        this scan's centroid. In pipelined mode the in-flight scans enter as
        hypothetical vertices at their predicted barycenters, and in
        asynchronous mode so do the kept scans the worker has not added to
        the graph yet (the JAX engine predicts for the wrong vertex while its
        worker lags, and its rows then miss). Returns ``(near, loop)``."""
        pred = self._predict_pose_host(odom)
        newbary = self._bary_of_pose(pred, np_points, np_mask)
        pend = [e["bary"] for e in (pending or [])]
        stored = self.store.barycenters()
        bary = np.concatenate([stored] + ([np.asarray(pend)] if pend else [])
                              + [newbary[None]])
        graph = self.backend.graph
        with graph._lock:             # the worker adds no vertex in between
            k = len(stored) - graph.num_vertices + len(pend) + 1
            near = [ch for ch in graph.find_near_chains_for_new(bary, k=k)
                    if len(ch) >= self.config.loop_match_min_chain_size]
            return near, graph.find_all_loop_candidates_for_new(bary, k=k)

    def _prepare_fused(self, near: list, loop: list, cap: int | None = None):
        """The chain batch of a fused step from the predicted ``near`` and
        ``loop`` chain sets (both take the matched pose as init and centre,
        so their coarse matches are one batch), of at most ``cap`` chains
        where given. Returns ``{"near", "loop", "ids" (bucket, K) int64
        array, "pose_version"}``, or None where nothing is predicted or the
        near chains do not fit one batch (that step is unfused)."""
        if not (near or loop):
            return None       # (before the batch limit, which reads the card)
        step = self.backend.chain_step(fused=True)
        if cap is not None:
            step = min(step, cap)
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
        t0 = _time.perf_counter()
        with self.timers.stage("backend_update"):
            for sid, cov, pre in batch:
                pre = self._fresh_prematched(pre)
                self.backend.update_graph(sid, cov,
                                          prematched=(pre or {}).get("near"))
        with self.timers.stage("backend_loop_closure"):
            pre = self._fresh_prematched(batch[-1][2])
            self.backend.try_close_loop(batch[-1][0],
                                        prematched=(pre or {}).get("loop"))
        self.diag.loop_closures = self.backend.num_loop_closures
        self.diag.backend_batches += 1
        self.diag.backend_batch_max = max(self.diag.backend_batch_max, len(batch))
        self.diag.backend_time_s += _time.perf_counter() - t0

    # ---- the pipelined fetch (JAX engine.py:849-1082) ----

    def _select_pipe_bucket(self) -> int:
        """The pipeline's chain bucket (at most 4): the most chains one
        pipelined step matches, shared by its dispatches and
        ``warm_backend``."""
        if self._pipe_bucket is None:
            lim = self.backend.max_parallel_chains(fused=True)
            self._pipe_bucket = max(
                (b for b in self.backend._BATCH_BUCKETS if b <= min(lim, 4)), default=1)
        return self._pipe_bucket

    def _pub_growth_needed(self, bmin: np.ndarray, bmax: np.ndarray) -> bool:
        spec = self.fspec.pub_spec
        off = self._host_pub_off
        extent = np.array([spec.width, spec.height]) * spec.resolution
        return bool((np.asarray(bmin) + off < 0).any()
                    or (np.asarray(bmax) + off > extent).any())

    def _drain_pipeline(self):
        """Reconcile every in-flight scan (events that rewrite or read maps
        call this first). Re-entrant: each reconcile pops its entry before it
        works, so a drain nested in a reconcile ends."""
        while self._inflight:
            self._reconcile_one()

    def _stage_scan(self, np_points, np_mask, odom, t: float, ids, cursor: int):
        """Everything a pipelined dispatch sends to the device in one copy: a
        float32 vector [points (P·2) | mask (P) | odom (3) | time since the
        first stamp (1) | store cursor (1) | chain ids (B·K)], in pinned
        memory on the card (a copy from pageable memory waits for the
        device). Returns the host buffer, which the caller keeps until the
        step has run, and device views of its parts."""
        P = np_points.shape[0]
        n = 3 * P + 5 + (0 if ids is None else ids.size)
        cuda = self.device.type == "cuda"
        host = torch.empty((n,), dtype=torch.float32, pin_memory=cuda)
        a = host.numpy()
        a[:2 * P] = np_points.reshape(-1)
        a[2 * P:3 * P] = np_mask
        a[3 * P:3 * P + 3] = odom
        a[3 * P + 3] = t - self._dev_time_origin      # float64, then rounded
        a[3 * P + 4] = cursor
        if ids is not None:
            a[3 * P + 5:] = ids.reshape(-1)
        buf = host.to(self.device, non_blocking=True) if cuda else host.clone()
        return host, {
            "points": buf[:2 * P].view(P, 2), "mask": buf[2 * P:3 * P] > 0.5,
            "odom": buf[3 * P:3 * P + 3], "time": buf[3 * P + 3],
            "cursor": buf[3 * P + 4:3 * P + 5].to(torch.int64),
            "ids": (None if ids is None
                    else buf[3 * P + 5:].view(ids.shape).to(torch.int64))}

    def _process_pipelined(self, np_points: np.ndarray, np_mask: np.ndarray,
                           n_valid: int, odom: np.ndarray, t: float) -> bool:
        """Dispatch this scan without waiting for any summary: the step's
        odometry prediction, move gate and store cursor live on the device,
        so chained dispatches need nothing from the reads in flight. Growth
        and capacity events drain the pipeline first. Host bookkeeping
        reconciles ``pipeline_depth`` scans behind. Returns True
        optimistically (acceptance is known at reconcile; the kept-scan
        accounting is exact, only this return value is early)."""
        t0 = _time.perf_counter()
        if any(e["may_rewrite_maps"] for e in self._inflight):
            # a scan in flight may close a loop or recenter the match maps
            # when it is reconciled: that happens before the next scan is
            # matched, as in the blocking engine
            self._drain_pipeline()
        pred = self._predict_pose_host(odom)
        # pub growth precedes the stamp; the pad covers the match-vs-predict
        # translation plus the pipeline's extra odometry lag
        bmin, bmax = self._scan_world_bbox(pred, np_points, np_mask)
        pad = self._search_pad() + 0.25
        if self._pub_growth_needed(bmin - pad, bmax + pad):
            self._drain_pipeline()
            with self._state_lock:
                self._grow_pub_to_bbox(bmin - pad, bmax + pad)
        # the store's device capacity never grows mid-pipeline (a re-upload
        # from the host would drop the in-flight rows)
        need = len(self.store) + len(self._inflight) + 2
        if self.store._dev_points is None or need > self.store._dev_cap:
            self._drain_pipeline()
            self.store.device_arrays(reserve=self.pipeline_depth + 2)
        self._select_pipe_bucket()
        near, loop = self._predict_chains(np_points, np_mask, odom,
                                          pending=self._inflight)
        fused_in = None
        if self._fused_backend:
            fused_in = self._prepare_fused(near, loop, cap=self._pipe_bucket)
        if not self._pipe_seeded:
            # the device move gate needs the time of the last scan through
            # the gate (blocking steps do not carry it)
            lt = (self._prev_process_time - self._dev_time_origin
                  if self._prev_process_time is not None else -3.4e38)
            self.state.last_step_time = torch.full(
                (), lt, dtype=torch.float32, device=self.device)
            self._pipe_seeded = True
        seed = not self._inflight
        if seed:
            # an empty pipeline: the host store is whole, so the device rows
            # and poses are brought up to it (after a correction the poses
            # are stale) and the cursor starts at its length
            self.store.device_arrays()
        entry = self._dispatch_pipelined(np_points, np_mask, n_valid, odom, t,
                                         fused_in, seed)
        self._move_ref_odom = odom.copy()
        entry.update(fused_in=fused_in,
                     may_rewrite_maps=bool(loop) or self._may_recenter(pred),
                     np_points=np_points.copy(),
                     np_mask=np_mask.copy(), n_valid=n_valid, odom=odom.copy(),
                     t=float(t), bary=self._bary_of_pose(pred, np_points, np_mask))
        self._inflight.append(entry)
        self.diag.match_time_s += _time.perf_counter() - t0
        while len(self._inflight) > self.pipeline_depth:
            self._reconcile_one()
        return True

    def _may_recenter(self, pred: np.ndarray) -> bool:
        """Whether a scan predicted at ``pred`` may recenter the match maps
        (``_maybe_recenter``) once matched: the predicted pose within the
        growth pad of the quarter-window bound."""
        if self.config.match_map_window <= 0:
            return False
        fs = self.fspec.fine_spec
        extent = np.array([fs.width, fs.height]) * fs.resolution
        center_w = extent * 0.5 - self._host_fine_off
        reach = 0.25 * float(extent.min()) - self._search_pad() - 0.25
        return bool(np.max(np.abs(pred[:2] - center_w)) > reach)

    def _dispatch_pipelined(self, np_points, np_mask, n_valid: int, odom, t: float,
                            fused_in, seed_cursor: bool) -> dict:
        """Launch one pipelined step and the copy of its packed vector into
        pinned host memory behind an event; reads nothing."""
        ids = None if fused_in is None else fused_in["ids"]
        host_in, d = self._stage_scan(np_points, np_mask, odom, t, ids,
                                      len(self.store))
        if seed_cursor:
            self._dev_cursor = d["cursor"]
        if fused_in is not None:
            self.diag.fused_steps += 1
        pts_d, msk_d, poses_d = (self.store._dev_points, self.store._dev_masks,
                                 self.store._dev_poses)
        with self._state_lock, self.timers.stage("pipe_dispatch"):
            self.state, _, packed = fused_cursor_step(
                self.fspec, self.bspec, self.state, d["points"], d["mask"], n_valid,
                d["odom"], d["time"], pts_d, msk_d, poses_d, d["ids"],
                self._dev_cursor)
            if self.device.type == "cuda":
                host_out = torch.empty(packed.shape, dtype=torch.float32,
                                       pin_memory=True)
                host_out.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host_out, event = packed, None
        return {"host_in": host_in, "host_out": host_out, "event": event}

    def _reconcile_one(self) -> bool:
        """Complete the oldest in-flight scan: wait for its packed vector,
        commit store, trajectory and mirrors, update the graph, then the
        events (recenter, snapshot, growth, loop closure), each draining the
        rest of the pipeline first. Returns whether the scan was kept."""
        e = self._inflight.pop(0)
        with self.timers.stage("frontend_fetch"):
            if e["event"] is not None:
                e["event"].synchronize()
            s = e["host_out"].numpy().astype(np.float64)
        accepted = bool(s[12] > 0.5)
        pose = s[:3].copy()
        self._host_pose = pose.copy()
        # the back end's pub snapshot is refreshed for every reconciled scan,
        # the rejected ones too (the JAX engine returns before it)
        with self._state_lock:
            self._publish_pub_arrays()
        if not accepted:
            # a pose rejected although its score cleared the accept threshold
            # was stopped by the device's move gate, which the blocking engine
            # counts at its host move gate; an accepted pose without a map
            # update failed the map-update gate (the JAX engine reads the
            # score alone and counts those as move drops too)
            if s[13] < 0.5 and s[14] > max(0.5, self.config.map_update_score_threshold):
                self.diag.scans_dropped_move += 1
            else:
                self.diag.scans_dropped_gate += 1
            return False
        t0 = _time.perf_counter()
        self.diag.scans_processed += 1
        # ---- commit: no nested drain until the graph vertex exists — the
        # device wrote this scan's row before any younger scan's, and store
        # ids, device rows and vertex ids must follow that order ----
        self._last_kept_odom = e["odom"].copy()
        with self._state_lock:
            scan_id = self.store.add(e["np_points"], e["np_mask"], e["n_valid"],
                                     pose, e["odom"], e["t"], dev_row=True)
            self.trajectory.append((e["t"], pose))
            self._update_map_to_odom(pose, e["odom"])
        n_committed = len(self.store)
        if self.on_pose is not None:
            self.on_pose(e["t"], pose.copy())
        cov = s[3:12].reshape(3, 3)
        prematched = self._prematched(e["fused_in"], s[16:])
        pre = self._fresh_prematched(prematched)
        with self.timers.stage("backend_update"):
            self.backend.update_graph(scan_id, cov, prematched=(pre or {}).get("near"))
        # ---- events: this scan is committed, so a drain keeps the order ----
        if self.config.match_map_window > 0:
            fs = self.fspec.fine_spec
            extent = np.array([fs.width, fs.height]) * fs.resolution
            center_w = extent * 0.5 - self._host_fine_off
            if np.max(np.abs(pose[:2] - center_w)) > 0.25 * min(extent):
                self._drain_pipeline()        # a recenter rebuilds the maps
            with self._state_lock:
                self._maybe_recenter(pose, upto=scan_id)
        else:
            self._check_world_bounds(pose)
        if (self.map_snapshot_every > 0 and self.on_map_snapshot is not None
                and n_committed % self.map_snapshot_every == 0):
            self._drain_pipeline()            # the rendered map must be current
            self.on_map_snapshot(len(self.store), self.get_pub_map())
        # post-match clip safety net: the rebuild reads the whole store
        bmin, bmax = self._scan_world_bbox(pose, e["np_points"], e["np_mask"])
        if self._pub_growth_needed(bmin, bmax):
            self._drain_pipeline()
            with self._state_lock:
                self._grow_pub_to_bbox(bmin, bmax)
                self.diag.pub_clip_rebuilds += 1
                self._rebuild_pub()
        # a closure corrects every pose and rebuilds every map: attempted
        # only where candidates exist, with the pipeline drained
        if self.backend.graph.find_all_loop_candidates(scan_id, self.store.barycenters()):
            self._drain_pipeline()
            pre = self._fresh_prematched(prematched)
            with self.timers.stage("backend_loop_closure"):
                self.backend.try_close_loop(scan_id,
                                            prematched=(pre or {}).get("loop"))
        self.diag.loop_closures = self.backend.num_loop_closures
        self.diag.backend_time_s += _time.perf_counter() - t0
        return True

    # ---- asynchronous back end (the reference's back-end thread) ----

    def _backend_worker(self, stream):
        """Drain the queue batch-wise, exactly the reference's condvar loop
        (BackEndProcessThread, slam_processor.cpp:384-426): graph updates
        for every buffered scan, then one loop-closure pass at the newest.
        Launches go to ``stream``, the front end's. An exception is kept
        for the front end to raise (``_raise_backend_error``) and ends the
        worker."""
        try:
            if stream is not None:
                torch.cuda.set_device(self.device)
                torch.cuda.set_stream(stream)
            while True:
                batch = [self._backend_queue.get()]
                while True:        # drain without blocking (buffer drain, :405)
                    try:
                        batch.append(self._backend_queue.get_nowait())
                    except _queue.Empty:
                        break
                stop = batch[-1] is None
                if stop:
                    batch.pop()
                if batch:
                    self._backend_pass(batch)
                if stop:
                    return
        except Exception as err:  # noqa: BLE001 — raised again on the front end
            self._backend_error = err

    def _ensure_backend_thread(self):
        """(Re)start the worker: finish() joins it, and the engine stays
        usable afterwards (the next kept scan starts it again)."""
        self._raise_backend_error()
        if self._backend_thread is None or not self._backend_thread.is_alive():
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
            self._backend_thread = threading.Thread(
                target=self._backend_worker, args=(stream,),
                name="slam-backend", daemon=True)
            self._backend_thread.start()

    def _raise_backend_error(self):
        if self._backend_error is not None:
            raise self._backend_error

    def finish(self):
        """Reconcile the scans in flight, flush pending back-end work; in
        asynchronous mode join the worker. NOT terminal: further process()
        calls continue the run (and start the worker again). Raises the
        worker's exception if it failed."""
        self._drain_pipeline()
        self.process_backend()
        thread = self._backend_thread
        if thread is not None and thread.is_alive():
            self._backend_queue.put(None)
            thread.join()
        self._backend_thread = None
        self._raise_backend_error()

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
        is inside its extent; returns True if it grew. Callers hold the
        state lock, so that the need is read and the map grown in one hold
        (the worker's corrections grow the map too)."""
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
        with self._state_lock:
            self._grow_pub_to_bbox(bmin, bmax)
            self.diag.pub_clip_rebuilds += 1
            self._rebuild_pub()

    def _rebuild_pub(self):
        """Rebuild the pub map from every stored scan at its current pose
        (InitMapWithRangeVec on the pub map, slam_processor.cpp:350-366).
        Callers hold the state lock."""
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
        the old content ``shift`` cells from the new low edge. Callers hold
        the state lock."""
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

    def _maybe_recenter(self, pose: np.ndarray, upto: int | None = None):
        """Rolling-window scan-match maps: when the pose drifts beyond a
        quarter window from the window center, re-center the fine+coarse
        maps on it. Newly covered area is NOT left unknown: the maps are
        rebuilt from every stored scan whose beams can reach the new window,
        so revisiting a long-left region matches against real content
        exactly like the reference's ever-growing maps
        (grid_map_base.h:188-274). The pub map keeps the global extent (it
        is the published product). ``upto``: rebuild from the stored scans
        before this id only (the pipelined reconcile has committed the scan
        already; the blocking engine recenters before it does)."""
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
                                    self._host_coarse_off - shift_m, upto)

    def _rebuild_match_maps_at(self, fine_off: np.ndarray,
                               coarse_off: np.ndarray, upto: int | None = None):
        """Fresh fine+coarse match maps at the given offsets, stamped from
        the stored scans within beam reach of the new window — exactly those
        (the JAX package pads the batch to size buckets only to bound
        recompilation). Keeps the host mirrors of both offsets in step.
        Callers hold the state lock."""
        t0 = _time.perf_counter()
        cfg = self.config
        fs, cs = self.fspec.fine_spec, self.fspec.coarse_spec
        self._host_fine_off = np.asarray(fine_off, np.float64)
        self._host_coarse_off = np.asarray(coarse_off, np.float64)
        extent = np.array([fs.width, fs.height]) * fs.resolution
        center_new = extent * 0.5 - fine_off
        reach = 0.5 * float(extent.max()) + self.laser.range_threshold
        poses = self.store.poses_array()[:upto]
        ids = []
        if len(poses):
            d = np.abs(poses[:, :2] - center_new[None]).max(1)
            ids = np.flatnonzero(d <= reach)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.state.coarse, self.state.fine = _stamp_match_maps(
            cs, fs, torch.as_tensor(coarse_off, **f32),
            torch.as_tensor(fine_off, **f32), *self.store.gather(ids),
            bool(cfg.coarse_map_use_blur), bool(cfg.fine_map_use_blur))
        self.diag.recenters += 1
        self.diag.recenter_time_s += _time.perf_counter() - t0

    # ---- corrections (CorrectPoseAndMap, slam_processor.cpp:329-370) ----

    def _apply_corrections(self, corrected: np.ndarray):
        """Install the solved poses of the first ``len(corrected)`` scans and
        rebuild every map, under the state lock (the back end calls this,
        on the worker's thread in asynchronous mode)."""
        with self._state_lock:
            n_corr = corrected.shape[0]
            n = len(self.store)
            if n_corr == 0 or n == 0:
                return
            if n_corr < n:
                # asynchronous mode: scans kept after the solve's snapshot are
                # not in ``corrected``. Re-anchor them with the last corrected
                # scan's rigid delta so that their placement relative to the
                # corrected trajectory is kept before every map is rebuilt
                # round them (the reference corrects EVERY stored scan under the
                # map mutex, CorrectPoseAndMap, slam_processor.cpp:329-370).
                old = np.asarray(self.store.poses[n_corr - 1], np.float64)
                new = np.asarray(corrected[n_corr - 1], np.float64)
                dth = new[2] - old[2]
                c_d, s_d = np.cos(dth), np.sin(dth)
                for sid in range(n_corr, n):
                    p = np.asarray(self.store.poses[sid], np.float64)
                    rel = p[:2] - old[:2]
                    th = p[2] + dth
                    self.store.set_pose(sid, np.array([
                        new[0] + c_d * rel[0] - s_d * rel[1],
                        new[1] + s_d * rel[0] + c_d * rel[1],
                        np.arctan2(np.sin(th), np.cos(th))]))
            for sid in range(n_corr):
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
            # corrections move the map frame under the odometry: refresh
            # map→odom so that pose_at(t) jumps WITH the correction (the
            # reference recomputes it at the next matched scan)
            self._update_map_to_odom(self._host_pose,
                                     np.asarray(self.store.odoms[-1], np.float64))
            new_pose = torch.as_tensor(self.store.poses[-1], dtype=torch.float32,
                                       device=self.device)
            st.pose = new_pose
            st.last_map_update_pose = new_pose.clone()
            for i, (t, _) in enumerate(self.trajectory):
                self.trajectory[i] = (t, self.store.poses[i].copy())
            self._publish_pub_arrays()

    # ---- fixed-rate pose stream (PublishTransform thread analog,
    #      roborts_slam_node.cpp:178-196) ----

    def _update_map_to_odom(self, pose: np.ndarray, odom: np.ndarray):
        """map→odom = pose ∘ odom⁻¹: the SE(2) transform that carries the
        odometry frame onto the map frame, refreshed whenever a matched pose
        pairs with a known odometry (per kept scan and per correction) — the
        reference computes exactly this after each accepted match
        (roborts_slam_node.cpp:124-135) and broadcasts it at 100 Hz."""
        dth = pose[2] - odom[2]
        c, s = np.cos(dth), np.sin(dth)
        self._map_to_odom = np.array([
            pose[0] - (c * odom[0] - s * odom[1]),
            pose[1] - (s * odom[0] + c * odom[1]),
            dth])

    def _interp_odom(self, t: float) -> np.ndarray | None:
        """Odometry pose at time t, linearly interpolated from the rolling
        history (shortest arc on the angle); clamps outside the span."""
        h = self._odom_history
        if not h:
            return None
        if t <= h[0][0]:
            return h[0][1].copy()
        if t >= h[-1][0]:
            return h[-1][1].copy()
        for (t0, o0), (t1, o1) in zip(h, h[1:]):
            if t0 <= t <= t1:
                a = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
                dth = np.arctan2(np.sin(o1[2] - o0[2]), np.cos(o1[2] - o0[2]))
                return np.array([o0[0] + a * (o1[0] - o0[0]),
                                 o0[1] + a * (o1[1] - o0[1]),
                                 o0[2] + a * dth])
        return h[-1][1].copy()

    def pose_at(self, t: float) -> np.ndarray:
        """Best pose estimate at an arbitrary time ``t`` — the decoupled pose
        channel the reference serves through its 100 Hz map→odom TF
        broadcast (roborts_slam_node.cpp:178-196): the latest map→odom
        transform (which jumps at corrections) composed with odometry
        interpolated at ``t``, so consumers get a pose BETWEEN kept scans
        without waiting for the next match."""
        o = self._interp_odom(t)
        if o is None or not self.config.use_odometry:
            return self._host_pose.copy()
        tx, ty, dth = self._map_to_odom
        c, s = np.cos(dth), np.sin(dth)
        th = dth + o[2]
        return np.array([tx + c * o[0] - s * o[1],
                         ty + s * o[0] + c * o[1],
                         np.arctan2(np.sin(th), np.cos(th))])

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

    def run_stream(self, stream, progress: bool = False) -> np.ndarray:
        """Consume a ``NativeScanStream`` (io/native_log.py): points are
        decoded and gated by the native worker ahead of the engine."""
        for i, (_idx, pts, msk, nv, t, odom) in enumerate(stream):
            self.process_points(pts, msk, nv, odom, t)
            if progress and i % 50 == 0:
                print(f"  scan {i} kept={len(self.store)} "
                      f"loops={self.backend.num_loop_closures}")
        self.finish()
        return self.trajectory_array()

    def trajectory_array(self) -> np.ndarray:
        with self._state_lock:
            return np.array([[t, p[0], p[1], p[2]] for t, p in self.trajectory])

    def get_pub_map(self) -> np.ndarray:
        """Published occupancy grid: -1 unknown / 0 free / 100 occupied
        (PublishMapThread, roborts_slam_node.cpp:427-469)."""
        self._drain_pipeline()
        cfg = self.config
        with self._state_lock:
            states = count_map_states(self.state.pub, cfg.map_min_passthrough,
                                      cfg.map_occu_threshold)
        return states.cpu().numpy()

    def force_graph_optimize(self):
        """ForceComputeByCeres: one SPA solve and correction now (after the
        asynchronous worker, if any, has taken every queued scan)."""
        self.finish()
        self.backend.force_optimize()

    def _clone_state(self):
        """A copy of the front-end state on the device (warm-up steps run on
        it and leave the engine's maps as they were)."""
        st = self.state
        return dataclasses.replace(
            st, pub=CountMap(st.pub.hits.clone(), st.pub.passes.clone(),
                             st.pub.offset.clone()),
            coarse=ProbMap(st.coarse.probs.clone(), st.coarse.offset.clone()),
            fine=ProbMap(st.fine.probs.clone(), st.fine.offset.clone()),
            **{f: getattr(st, f).clone() for f in (
                "pose", "last_map_update_pose", "map_penalize_times",
                "scan_index", "last_kept_odom", "last_step_time")})

    def _warm_fused(self, b: int, cursor: bool):
        """One fused step (``cursor``: the pipelined one) at chain bucket
        ``b`` on an empty scan and empty chains, on a copy of the state and
        into the store's first free device row (dead until a kept scan
        writes it); on the card its peak memory goes to the back end's
        fused figures, which cap the fused batch."""
        dev = self.device
        K, P = self.bspec.max_chain_scans, self.store.max_points
        with self.store._lock:
            rows = self.store.device_arrays(reserve=1)
            slot = self.store._dev_count
        ids = torch.full((b, K), -1, dtype=torch.int64, device=dev)
        scan = (torch.zeros((P, 2), dtype=torch.float32, device=dev),
                torch.zeros((P,), dtype=torch.bool, device=dev), 0,
                torch.zeros(3, dtype=torch.float32, device=dev))
        state = self._clone_state()
        if cursor:
            run = lambda: fused_cursor_step(
                self.fspec, self.bspec, state, *scan,
                torch.zeros((), dtype=torch.float32, device=dev), *rows, ids,
                torch.full((1,), slot, dtype=torch.int64, device=dev))
        else:
            run = lambda: fused_frontend_chain_step(
                self.fspec, self.bspec, state, *scan, *rows, ids, slot)
        if dev.type == "cuda":
            self.backend._measured_mem_fused[b] = self.backend.peak_bytes(run)
        else:
            run()

    def warm_backend(self, solver_buckets: tuple[int, ...] = (64, 128, 256),
                     match_buckets: tuple[int, ...] | None = None,
                     rebuild_buckets: tuple[int, ...] = (64, 128, 256),
                     calibrate: bool = True):
        """Do once, before streaming, what the back end's first calls would
        do the first time: on the card, build the kernels and (``calibrate``)
        measure each chain bucket's peak memory, which sets the batch size
        (``Backend.calibrate_chain_batch``); run one chain batch at each of
        ``match_buckets`` (default: every bucket up to that size), one fused
        step at each of them (the pipelined step at the pipeline's bucket
        instead, where it runs), recording the fused step's peak memory on
        the card; one SPA solve of the live graph and one rebuild of every
        map from the live store. Results are discarded and no engine, store
        or graph state changes (the back end's counters are put back), so a
        run continued after warming equals the unwarmed run bit for bit.
        Call it after the first scan.

        ``solver_buckets`` and ``rebuild_buckets`` are the JAX package's and
        are ignored: PyTorch compiles nothing per shape."""
        from .backend.spa import solve_pose_graph

        if len(self.store) == 0:
            raise RuntimeError("warm_backend needs >= 1 processed scan")
        self.finish()
        if self.device.type == "cuda":
            from .ops.cuda import build

            build.build_all()
        back = self.backend
        counters = (back.num_chain_dispatches, back.chain_match_time_s,
                    back.num_solves, back.solve_time_s)
        try:
            if calibrate:
                back.calibrate_chain_batch()
            step = back.chain_step()
            if match_buckets is None:
                match_buckets = tuple(b for b in back._BATCH_BUCKETS if b <= step)
            for b in match_buckets:
                if b <= step:
                    back._match_chain_batch([[0]] * b, 0, self.store.poses[0].copy())
            if self._fused_backend and not self.config.use_running_range_scan_match:
                with self._state_lock:
                    if self.pipelined_fetch and self.synchronous_backend:
                        self._warm_fused(self._select_pipe_bucket(), cursor=True)
                    else:
                        for b in match_buckets:
                            if b <= step:
                                self._warm_fused(b, cursor=False)
            graph = back.graph
            if graph.num_vertices > 1:
                solve_pose_graph(graph.as_solver_data(self.store.poses_array(),
                                                      self.device))
            cfg = self.config
            with self._state_lock:
                st = self.state
                _rebuild_all_maps(
                    self.fspec.pub_spec, self.fspec.coarse_spec,
                    self.fspec.fine_spec, st.pub.offset, st.coarse.offset,
                    st.fine.offset, *self.store.all_arrays(),
                    cfg.map_update_free_factor, cfg.map_update_occu_factor,
                    int(cfg.map_min_passthrough),
                    bool(cfg.coarse_map_use_blur), bool(cfg.fine_map_use_blur))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            (back.num_chain_dispatches, back.chain_match_time_s,
             back.num_solves, back.solve_time_s) = counters
