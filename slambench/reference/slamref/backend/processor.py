"""Back-end orchestration: graph update, chain matching, loop closure.

Counterpart of the JAX package's ``backend/processor.py`` (the back-end half
of ``SlamProcessor`` + ``RangeScanPoseGraph``, slam_processor.cpp:250-426,
range_scan_pose_graph.cpp:44-355): the engine calls ``update_graph`` /
``try_close_loop`` per kept scan.

Heavy pieces run on the device:
- ``chain_match``: rebuild back-end coarse+fine maps from (padded) chains of
  scans and run the full 3-tier match of the current scan against them —
  the reference's ScanMatchInterface (slam_processor.cpp:250-326). Where
  the JAX package ``vmap``s a single-chain function, the chain dimension is
  written out here: maps are ``(B, H, W)`` and every op below is batched.
  A batch is padded with empty chains to a size of ``_BATCH_BUCKETS`` and
  candidate chains are cut into batches of the largest bucket whose peak
  memory fits the card (``max_parallel_chains``), as in the JAX package.
- ``fused_frontend_chain_step``: the front-end step, the chain batch of the
  chains predicted for the scan and the store row written on the device,
  with the step's summary and the chain rows packed into one vector, which
  the engine reads once per scan.
- ``solve_packed``: the SPA solve (backend/spa.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..config import SlamConfig
from ..models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, backend_map_specs,
)
from ..frontend.matchers import MatcherParams, scan_match
from ..frontend.processor import frontend_step
from ..ops.correlative import valid_count
from ..ops.raster import stamp_scan_batch
from ..ops.raycast import map_feedback_penalty
from .pose_graph import PoseGraph
from .spa import solve_packed

@dataclasses.dataclass(frozen=True)
class BackendSpec:
    config: SlamConfig
    coarse_spec: ProbMapSpec
    fine_spec: ProbMapSpec
    pub_spec: CountMapSpec
    matcher: MatcherParams
    max_chain_scans: int

    @staticmethod
    def from_config(config: SlamConfig, laser_range_max: float,
                    pub_spec: CountMapSpec) -> "BackendSpec":
        coarse, fine = backend_map_specs(config, laser_range_max)
        return BackendSpec(
            config=config, coarse_spec=coarse, fine_spec=fine,
            pub_spec=pub_spec,
            # all back-end calls use the front-end matcher params
            # (LinkNearChains/TryCloseLoop pass use_front_end=true,
            # range_scan_pose_graph.cpp:153, :312-318, :329)
            matcher=MatcherParams.from_config(config),
            max_chain_scans=config.max_chain_scans,
        )


def chain_match(spec: BackendSpec,
                chain_points, chain_masks, chain_poses, chain_valid,
                points, mask, n_valid, init_pose, center_pose,
                pub_hits, pub_passes, pub_offset):
    """ScanMatchInterface (slam_processor.cpp:250-326) for ``B`` chains at
    once: back-end maps recentered on ``center_pose``
    (ResetScanMatchMapWithRangeVec :448-462), rebuilt from each chain in one
    batched stamp, 3-tier match, then the logistic pub-map penalty (:313-317).

    chain_points (B,K,P,2), chain_masks (B,K,P), chain_poses (B,K,3),
    chain_valid (B,K); init_pose (B,3); center_pose (3,) shared. Returns
    (pose (B,3), score (B,), cov (B,3,3))."""
    cfg = spec.config
    B = chain_points.shape[0]
    dev = chain_points.device
    n_valid = valid_count(n_valid, dev)

    def recentered(pspec: ProbMapSpec) -> ProbMap:
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = torch.stack([-(center_pose[0] - 0.5 * size_x),
                           -(center_pose[1] - 0.5 * size_y)])
        probs = torch.full((B, pspec.height, pspec.width), pspec.default_prob,
                           dtype=torch.float32, device=dev)
        return ProbMap(probs, off)

    fine = stamp_scan_batch(spec.fine_spec, recentered(spec.fine_spec),
                            chain_points, chain_masks, chain_poses,
                            chain_valid, use_blur=cfg.fine_map_use_blur)
    # every correlative tier reads the fine map; only the optimize matcher
    # reads the coarse chain maps, so they are built only for it
    coarse = ProbMap(None, None)
    if spec.matcher.use_optimize_scan_match:
        coarse = stamp_scan_batch(
            spec.coarse_spec, recentered(spec.coarse_spec), chain_points,
            chain_masks, chain_poses, chain_valid,
            use_blur=cfg.coarse_map_use_blur)

    out = scan_match(
        spec.matcher,
        spec.fine_spec, fine.probs, fine.offset,
        spec.coarse_spec, coarse.probs, coarse.offset,
        points, mask, n_valid, init_pose,
    )

    if cfg.use_map_check_feedback:
        pub = CountMap(hits=pub_hits, passes=pub_passes, offset=pub_offset)
        penalty = map_feedback_penalty(
            spec.pub_spec, pub, points, mask, n_valid, out.pose,
            cfg.map_check_point_num, cfg.map_check_bound_tolerance,
            cfg.map_check_penalty_gain,
            min_passthrough=cfg.map_min_passthrough,
            occu_threshold=cfg.map_occu_threshold,
        )
        # logistic squashing for the back end (slam_processor.cpp:589-591)
        penalty = 1.0 / (1.0 + torch.exp(-10.0 * (penalty - 0.4)))
        score = torch.clamp(out.score * penalty, max=1.0)
    else:
        score = out.score
    return out.pose, score, out.cov


def chain_match_batch_gather(spec: BackendSpec,
                             all_points, all_masks, all_poses,
                             chain_ids, scan_id: int, n_valid: int,
                             init_poses, center_pose,
                             pub_hits, pub_passes, pub_offset):
    """All candidate chains of one LinkNearChains / TryCloseLoop pass matched
    in one batched call (the reference loops chains serially,
    range_scan_pose_graph.cpp:125-164), with the scans gathered on the
    device from the store's resident buffers by a (B, K) id matrix
    (-1 = padding). Per call the host ships only ids + init poses.
    ``scan_id``: a host int, or a (1,) int64 tensor on the device (with
    ``n_valid`` a device scalar: nothing of the call is then a host value)."""
    ids = torch.clamp(chain_ids, min=0)
    valid = chain_ids >= 0                              # (B, K)
    cp = all_points[ids]                                # (B, K, P, 2)
    cm = all_masks[ids] & valid[..., None]
    cpo = all_poses[ids]
    if isinstance(scan_id, torch.Tensor):
        points, mask = (all_points.index_select(0, scan_id)[0],
                        all_masks.index_select(0, scan_id)[0])
    else:
        points, mask = all_points[scan_id], all_masks[scan_id]
    return chain_match(spec, cp, cm, cpo, valid, points, mask, n_valid,
                       init_poses, center_pose,
                       pub_hits, pub_passes, pub_offset)


def _chain_rows(bspec: BackendSpec, state, store_points, store_masks,
                store_poses, chain_ids, points, mask, n_valid, pose):
    """Match the scan against the chains of ``chain_ids (B, K)`` (-1 =
    padding) gathered on the device from the store's rows, with the matched
    ``pose`` as init and centre and the front end's post-update pub map as
    feedback: what ``Backend._match_chain_batch`` would compute for the same
    chains after the scan is kept. Returns the (B·13,) rows pose(3) +
    score(1) + cov(9)."""
    ids = torch.clamp(chain_ids, min=0)
    valid = chain_ids >= 0
    B = chain_ids.shape[0]
    bpose, bscore, bcov = chain_match(
        bspec, store_points[ids], store_masks[ids] & valid[..., None],
        store_poses[ids], valid, points, mask, n_valid,
        pose[None].expand(B, 3), pose,
        state.pub.hits, state.pub.passes, state.pub.offset)
    return torch.cat([bpose.to(torch.float32), bscore[:, None].to(torch.float32),
                      bcov.reshape(B, 9).to(torch.float32)], dim=1).reshape(-1)


def _slot_index(slot, device) -> torch.Tensor:
    """A store row as a (1,) int64 index on the device (a host int is
    written by one fill)."""
    if isinstance(slot, torch.Tensor):
        return slot
    return torch.full((1,), int(slot), dtype=torch.int64, device=device)


def fused_frontend_chain_step(fspec, bspec: BackendSpec, state,
                              points, mask, n_valid, cur_odom,
                              store_points, store_masks, store_poses,
                              chain_ids, store_slot):
    """The front-end step, the LinkNearChains / TryCloseLoop-coarse chain
    batch of the chains predicted for this scan, and the store append, all
    on the device (JAX ``_fused_frontend_chain_impl``); nothing is read: the
    caller reads the packed vector once. The maps are updated under the gate
    on the device (``frontend_step(device_gate=True)``); the chain batch
    takes the matched pose as init and centre and the post-update pub map,
    so where the predicted chain set is the real one its rows are what the
    separate batch would give (the consumer checks the sets and matches
    again where they differ). The scan is written at ``store_slot`` (a (1,)
    int64 tensor or a host int) of the store's device rows whether it is
    kept or not: a rejected scan's row is dead until the next kept scan
    overwrites it, and the batch reads only rows below the slot. Returns
    ``(state, info, packed)``, ``packed`` the (15 + B·13,) device vector:
    the step's summary, then each chain row. On the card the engine
    captures this in a CUDA graph."""
    state, info = frontend_step(fspec, state, points, mask, n_valid, cur_odom,
                                device_gate=True)
    rows = _chain_rows(bspec, state, store_points, store_masks, store_poses,
                       chain_ids, points, mask, n_valid, info.pose)
    slot = _slot_index(store_slot, points.device)
    store_points.index_copy_(0, slot, points[None])
    store_masks.index_copy_(0, slot, mask[None])
    store_poses.index_copy_(0, slot, info.pose[None])
    return state, info, torch.cat([info.packed, rows])


class Backend:
    """Owns the pose graph; pulls scan data from the engine's store."""

    def __init__(self, spec: BackendSpec, store):
        self.spec = spec
        self.store = store              # engine ScanStore (duck-typed)
        cfg = spec.config
        self.graph = PoseGraph(cfg.link_scan_max_distance,
                               cfg.loop_match_min_chain_size)
        self.on_corrections: Callable | None = None   # set by engine
        self.num_loop_closures = 0
        self.num_links = 0
        self.num_chain_dispatches = 0     # separate chain-match batches
        self.num_solves = 0               # SPA solves
        self.num_fused_hits = 0           # fused chain rows taken
        self.num_fused_misses = 0         # predicted chain set diverged (or stale)
        self.chain_match_time_s = 0.0     # host clock, each call ends in its fetch
        self.solve_time_s = 0.0           # host clock, SPA solve + corrections
        self.diag = None

    # ---- device-call helpers ----

    _BATCH_BUCKETS = (1, 2, 4, 8, 16)   # chain-batch sizes (the JAX package's)

    def device_memory_budget(self) -> float:
        """Bytes a chain batch may plan for: on the card, 90 % of its memory
        less what is in use, blocks the allocator holds cached included (the
        allocator's statistics cost milliseconds of Python a read, the
        driver's free count one call); off the card the JAX package's
        fallback of 6e9, so that the CPU chooses the buckets the JAX package
        chooses there."""
        dev = self.store.device
        if dev.type != "cuda":
            return 6e9
        free, total = torch.cuda.mem_get_info(dev)
        return max(2.0e8, 0.9 * total - (total - free))

    def max_parallel_chains(self, fused: bool = False) -> int:
        """Largest chain batch the device can hold, by the JAX package's
        analytic model (the program measures no peak unless calibrated,
        which the benchmark does not do): each chain materialises its coarse
        + fine map rebuild, ~8 live f32 temporaries of map size, with 2.6x
        fragmentation."""
        budget = self.device_memory_budget()
        s = self.spec
        cells = (s.fine_spec.height * s.fine_spec.width
                 + s.coarse_spec.height * s.coarse_spec.width)
        per_chain = cells * 4 * 8 * 2.6
        return int(max(1, min(self._BATCH_BUCKETS[-1], budget // per_chain)))

    def chain_step(self, fused: bool = False) -> int:
        """The largest bucket not above ``max_parallel_chains``: batches are
        cut at this size (a batch is padded up to a bucket, so cutting at a
        cap that is no bucket would launch a padded batch past the cap)."""
        lim = self.max_parallel_chains(fused=fused)
        return max((b for b in self._BATCH_BUCKETS if b <= lim), default=1)

    def _match_chain_batch(self, chain_id_lists: list[list[int]],
                           scan_id: int, init_poses: np.ndarray):
        """Match one scan against its candidate chains, in batches of
        ``chain_step()``. ``init_poses``: (3,) shared, or (B, 3) per-chain."""
        step = self.chain_step()
        inits = np.asarray(init_poses, np.float32)
        if inits.ndim == 1:
            inits = np.tile(inits[None], (len(chain_id_lists), 1))
        out = []
        for i in range(0, len(chain_id_lists), step):
            out += self._match_chain_batch_one(
                chain_id_lists[i:i + step], scan_id, inits[i:i + step])
        return out

    def _batch_on_device(self, ids: np.ndarray, scan_id: int, inits: np.ndarray):
        """``chain_match_batch_gather`` on the (bucket, K) id matrix ``ids``
        and (bucket, 3) ``inits``: its inputs staged into one float32 vector
        [ids (B·K) | scan id | n_valid | inits (3B) | centre (3)], as the
        program stages them, gathering from the store's device rows and
        reading the pub map. Returns the device results."""
        st = self.store
        rows = st.device_arrays()
        # the pub map can grow mid-run: pair the arrays with the spec they
        # were built under
        pub_spec, *pub = st.pub_map_arrays()
        spec = (self.spec if pub_spec == self.spec.pub_spec
                else dataclasses.replace(self.spec, pub_spec=pub_spec))
        B, K = ids.shape
        a = np.empty((B * K + 5 + 3 * B,), np.float32)
        a[:B * K] = ids.reshape(-1)
        a[B * K:B * K + 2] = (scan_id, st.n_valid(scan_id))
        a[B * K + 2:B * K + 2 + 3 * B] = inits.reshape(-1)
        a[B * K + 2 + 3 * B:] = st.poses[scan_id]
        staged = torch.as_tensor(a).to(rows[0].device)
        o = B * K
        bpose, bscore, bcov = chain_match_batch_gather(
            spec, *rows, staged[:o].view(B, K).to(torch.int64),
            staged[o:o + 1].to(torch.int64), staged[o + 1].to(torch.int32),
            staged[o + 2:o + 2 + 3 * B].view(B, 3), staged[o + 2 + 3 * B:], *pub)
        return bpose.to(torch.float32), bscore.to(torch.float32), bcov.to(torch.float32)

    def _match_chain_batch_one(self, chain_id_lists: list[list[int]],
                               scan_id: int, inits: np.ndarray):
        """One batch of ``B`` chains, padded with empty chains (-1 ids, whose
        near-default score falls below every threshold) up to a bucket."""
        t0 = time.perf_counter()
        K = self.spec.max_chain_scans
        B = len(chain_id_lists)
        bucket = next((b for b in self._BATCH_BUCKETS if b >= B), B)
        ids = np.full((bucket, K), -1, np.int64)
        for b, chain in enumerate(chain_id_lists):
            ids[b, :min(len(chain), K)] = chain[:K]
        padded = np.zeros((bucket, 3), np.float32)
        padded[:B] = inits
        self.num_chain_dispatches += 1
        bpose, bscore, bcov = self._batch_on_device(ids, scan_id, padded)
        # ONE host fetch for all three results
        flat = torch.cat([bpose, bscore[:, None], bcov.reshape(bucket, 9)], dim=1) \
            .cpu().numpy().astype(np.float64)
        self.chain_match_time_s += time.perf_counter() - t0
        return [(flat[i, :3].copy(), float(flat[i, 3]),
                 flat[i, 4:].reshape(3, 3).copy()) for i in range(B)]

    # ---- graph construction (UpdateGraph, range_scan_pose_graph.cpp:44-78) ----

    def update_graph(self, scan_id: int, covariance: np.ndarray,
                     prematched=None):
        """``prematched``: optional ``(chains, rows)`` from a fused step — the
        chain set discovered from the predicted pose and its match rows. They
        are taken instead of a separate batch iff the real discovery (from
        the matched pose) finds the identical chain set."""
        vid = self.graph.add_vertex()
        assert vid == scan_id, (vid, scan_id)
        if scan_id > 0:
            self._link_scans(scan_id - 1, scan_id,
                             self.store.poses[scan_id], covariance)
            self._link_near_chains(scan_id, prematched=prematched)

    def _link_scans(self, source: int, target: int, mean: np.ndarray,
                    covariance: np.ndarray):
        """LinkScans (range_scan_pose_graph.cpp:102-118): edge from the
        source scan's pose to ``mean`` with the given covariance."""
        if self.graph.add_edge(source, target, self.store.poses[source],
                               mean, covariance):
            self.num_links += 1

    def _link_near_chains(self, scan_id: int, prematched=None):
        """LinkNearChains (range_scan_pose_graph.cpp:120-167); all eligible
        chains are matched in batched calls, or their rows taken from the
        fused step where its predicted chain set held."""
        cfg = self.spec.config
        bary = self.store.barycenters()
        chains = [c for c in self.graph.find_near_chains(scan_id, bary)
                  if len(c) >= cfg.loop_match_min_chain_size]
        if not chains:
            return
        if prematched is not None and prematched[0] == chains:
            results = prematched[1]
            self.num_fused_hits += 1
        else:
            if prematched is not None:
                self.num_fused_misses += 1
            init = self.store.poses[scan_id].copy()
            results = self._match_chain_batch(
                [PoseGraph.sparsify_chain(c) for c in chains], scan_id, init)
        for chain, (pose, response, cov) in zip(chains, results):
            if not np.all(np.isfinite(cov)):
                continue
            if response > cfg.link_match_min_response:
                self._link_chain_to_scan(chain, scan_id, pose, cov)

    def _link_chain_to_scan(self, chain: list[int], scan_id: int,
                            mean: np.ndarray, covariance: np.ndarray) -> int:
        """LinkChainToScan (range_scan_pose_graph.cpp:169-190)."""
        bary = self.store.barycenters()
        closest = PoseGraph.find_closest_scan_id(chain, scan_id, bary)
        d2 = float(np.sum((bary[scan_id, :2] - bary[closest, :2]) ** 2))
        if d2 < self.spec.config.link_scan_max_distance**2:
            self._link_scans(closest, scan_id, mean, covariance)
        return closest

    # ---- loop closure (TryCloseLoop, range_scan_pose_graph.cpp:299-355) ----

    def try_close_loop(self, scan_id: int, prematched=None) -> bool:
        """TryCloseLoop with batched verification: ALL candidate chains are
        coarse-matched together (the reference matches them one at a time,
        range_scan_pose_graph.cpp:299-355), the survivors fine-matched in a
        second pass, and the first fine acceptance closes the loop. A
        closure corrects every pose, so the remaining candidates are
        re-discovered against the corrected barycenters (the accepted chain
        becomes graph-linked and drops out), matching the reference's
        rescan-after-correction behavior. ``prematched``: the first round's
        coarse rows from a fused step, taken iff its chain set is the one
        found here."""
        cfg = self.spec.config
        closed = False
        for _round in range(8):        # closures per scan are few; bound it
            bary = self.store.barycenters()
            chains = self.graph.find_all_loop_candidates(scan_id, bary)
            if not chains:
                break
            if _round == 0 and prematched is not None and prematched[0] == chains:
                coarse = prematched[1]           # rode the fused step
                self.num_fused_hits += 1
            else:
                if _round == 0 and prematched is not None:
                    self.num_fused_misses += 1
                init = self.store.poses[scan_id].copy()
                coarse = self._match_chain_batch(chains, scan_id, init)
            passing = [
                (chain, pose) for chain, (pose, resp, cov) in zip(chains, coarse)
                if (resp > cfg.loop_match_min_response_coarse
                    and cov[0, 0] < cfg.loop_match_max_variance_coarse
                    and cov[1, 1] < cfg.loop_match_max_variance_coarse)
            ]
            if not passing:
                break
            # fine re-match from each coarse pose (second verification stage,
            # range_scan_pose_graph.cpp:329-333)
            fine_results = self._match_chain_batch(
                [c for c, _ in passing], scan_id,
                np.stack([p for _, p in passing]).astype(np.float32))
            accepted = False
            for (chain, _), (fine_pose, fine_resp, fine_cov) in zip(
                    passing, fine_results):
                if fine_resp >= cfg.loop_match_min_response_fine:
                    self.store.set_pose(scan_id, fine_pose)
                    self._link_chain_to_scan(chain, scan_id, fine_pose,
                                             fine_cov)
                    self._solve_and_correct()
                    closed = True
                    accepted = True
                    self.num_loop_closures += 1
                    break          # corrections moved everything: re-discover
            if not accepted:
                break
        return closed

    def _solve_and_correct(self):
        """One SPA solve of the whole graph, padded to JAX's buckets, and its
        corrections; the solve's poses come back in its one host read."""
        self.num_solves += 1
        t0 = time.perf_counter()
        n = self.graph.num_vertices
        data = self.graph.as_solver_data(self.store.poses_array(),
                                         self.store.device)
        packed, _ = solve_packed(data)
        # the solve stays on the device until here: its one host read
        out = packed.cpu().numpy()
        pn = data.poses.shape[0]
        corrected = out[:3 * pn].reshape(pn, 3).astype(np.float64)[:n]
        if self.on_corrections is not None:
            self.on_corrections(corrected)
        self.solve_time_s += time.perf_counter() - t0

