"""Back-end orchestration: graph update, chain matching, loop closure.

Counterpart of the JAX package's ``backend/processor.py`` (the back-end half
of ``SlamProcessor`` + ``RangeScanPoseGraph``, slam_processor.cpp:250-426,
range_scan_pose_graph.cpp:44-355), blocking path only: the engine calls
``update_graph`` / ``try_close_loop`` synchronously per kept scan.

Heavy pieces run on the device:
- ``chain_match``: rebuild back-end coarse+fine maps from (padded) chains of
  scans and run the full 3-tier match of the current scan against them —
  the reference's ScanMatchInterface (slam_processor.cpp:250-326). Where
  the JAX package ``vmap``s a single-chain function, the chain dimension is
  written out here: maps are ``(B, H, W)`` and every op below is batched.
- ``solve_pose_graph``: the SPA solve (backend/spa.py).

The JAX package's fused front-end+chain programs, batch-size buckets (padding
for bounded recompilation), compiler-measured memory calibration and AOT
warm-up have no counterpart: candidate chains are matched in fixed chunks of
``CHAIN_BATCH``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import SlamConfig
from ..models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, backend_map_specs,
)
from ..frontend.matchers import MatcherParams, scan_match
from ..ops.raster import stamp_scan_batch
from ..ops.raycast import map_feedback_penalty
from .pose_graph import PoseGraph
from .spa import solve_pose_graph

CHAIN_BATCH = 8     # chains matched per batched call (fixed small batch)


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
                points, mask, n_valid: int, init_pose, center_pose,
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

    def recentered(pspec: ProbMapSpec) -> ProbMap:
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = torch.stack([-(center_pose[0] - 0.5 * size_x),
                           -(center_pose[1] - 0.5 * size_y)])
        probs = torch.full((B, pspec.height, pspec.width), pspec.default_prob,
                           dtype=torch.float32, device=dev)
        return ProbMap(probs, off)

    # only the fine maps are matched against (every correlative tier reads
    # the fine map); the coarse chain maps fed the optimize matcher only
    fine = stamp_scan_batch(spec.fine_spec, recentered(spec.fine_spec),
                            chain_points, chain_masks, chain_poses,
                            chain_valid, use_blur=cfg.fine_map_use_blur)

    out = scan_match(
        spec.matcher,
        spec.fine_spec, fine.probs, fine.offset,
        spec.coarse_spec, None, None,
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
    (-1 = padding). Per call the host ships only ids + init poses."""
    ids = torch.clamp(chain_ids, min=0)
    valid = chain_ids >= 0                              # (B, K)
    cp = all_points[ids]                                # (B, K, P, 2)
    cm = all_masks[ids] & valid[..., None]
    cpo = all_poses[ids]
    return chain_match(spec, cp, cm, cpo, valid,
                       all_points[scan_id], all_masks[scan_id], n_valid,
                       init_poses, center_pose,
                       pub_hits, pub_passes, pub_offset)


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
        self.num_chain_dispatches = 0     # batched chain-match calls
        self.num_solves = 0               # SPA solves

    # ---- device-call helpers ----

    def _match_chain_batch(self, chain_id_lists: list[list[int]],
                           scan_id: int, init_poses: np.ndarray):
        """Match one scan against its candidate chains, ``CHAIN_BATCH`` at a
        time. ``init_poses``: (3,) shared, or (B, 3) per-chain."""
        inits = np.asarray(init_poses, np.float32)
        if inits.ndim == 1:
            inits = np.tile(inits[None], (len(chain_id_lists), 1))
        out = []
        for i in range(0, len(chain_id_lists), CHAIN_BATCH):
            out += self._match_chain_batch_one(
                chain_id_lists[i:i + CHAIN_BATCH], scan_id,
                inits[i:i + CHAIN_BATCH])
        return out

    def _match_chain_batch_one(self, chain_id_lists: list[list[int]],
                               scan_id: int, inits: np.ndarray):
        st = self.store
        K = self.spec.max_chain_scans
        B = len(chain_id_lists)
        ids = np.full((B, K), -1, np.int64)
        for b, chain in enumerate(chain_id_lists):
            ids[b, :min(len(chain), K)] = chain[:K]
        self.num_chain_dispatches += 1
        all_pts, all_msk, all_poses = st.device_arrays()
        dev = all_pts.device
        # the pub map can grow mid-run: pair the arrays with the spec they
        # were built under
        pub_spec, *pub = st.pub_map_arrays()
        spec = (self.spec if pub_spec == self.spec.pub_spec
                else dataclasses.replace(self.spec, pub_spec=pub_spec))
        bpose, bscore, bcov = chain_match_batch_gather(
            spec, all_pts, all_msk, all_poses,
            torch.as_tensor(ids, device=dev), scan_id, st.n_valid(scan_id),
            torch.as_tensor(inits, device=dev),
            torch.as_tensor(st.poses[scan_id], dtype=torch.float32, device=dev),
            *pub,
        )
        # ONE host fetch for all three results
        flat = torch.cat([bpose, bscore[:, None], bcov.reshape(B, 9)], dim=1) \
            .cpu().numpy().astype(np.float64)
        return [(flat[i, :3].copy(), float(flat[i, 3]),
                 flat[i, 4:].reshape(3, 3).copy()) for i in range(B)]

    # ---- graph construction (UpdateGraph, range_scan_pose_graph.cpp:44-78) ----

    def update_graph(self, scan_id: int, covariance: np.ndarray):
        vid = self.graph.add_vertex()
        assert vid == scan_id, (vid, scan_id)
        if scan_id > 0:
            self._link_scans(scan_id - 1, scan_id,
                             self.store.poses[scan_id], covariance)
            self._link_near_chains(scan_id)

    def _link_scans(self, source: int, target: int, mean: np.ndarray,
                    covariance: np.ndarray):
        """LinkScans (range_scan_pose_graph.cpp:102-118): edge from the
        source scan's pose to ``mean`` with the given covariance."""
        if self.graph.add_edge(source, target, self.store.poses[source],
                               mean, covariance):
            self.num_links += 1

    def _link_near_chains(self, scan_id: int):
        """LinkNearChains (range_scan_pose_graph.cpp:120-167); all eligible
        chains are matched in batched calls."""
        cfg = self.spec.config
        bary = self.store.barycenters()
        chains = [c for c in self.graph.find_near_chains(scan_id, bary)
                  if len(c) >= cfg.loop_match_min_chain_size]
        if not chains:
            return
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

    def try_close_loop(self, scan_id: int) -> bool:
        """TryCloseLoop with batched verification: ALL candidate chains are
        coarse-matched together (the reference matches them one at a time,
        range_scan_pose_graph.cpp:299-355), the survivors fine-matched in a
        second pass, and the first fine acceptance closes the loop. A
        closure corrects every pose, so the remaining candidates are
        re-discovered against the corrected barycenters (the accepted chain
        becomes graph-linked and drops out), matching the reference's
        rescan-after-correction behavior."""
        cfg = self.spec.config
        closed = False
        for _round in range(8):        # closures per scan are few; bound it
            bary = self.store.barycenters()
            chains = self.graph.find_all_loop_candidates(scan_id, bary)
            if not chains:
                break
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

    def force_optimize(self):
        """ForceComputeByCeres equivalent (range_scan_pose_graph.cpp:400-407)."""
        if self.graph.num_vertices > 1:
            self._solve_and_correct()

    def _solve_and_correct(self):
        self.num_solves += 1
        data = self.graph.as_solver_data(self.store.poses_array(),
                                         self.store.device)
        poses, _cost, _iters = solve_pose_graph(data)
        corrected = poses.cpu().numpy().astype(np.float64)[: self.graph.num_vertices]
        if self.on_corrections is not None:
            self.on_corrections(corrected)

    def graph_info(self):
        """GetGraphInfo equivalent: (node xy array, edge endpoint pairs)."""
        poses = self.store.poses_array()
        nodes = poses[: self.graph.num_vertices, :2]
        edges = [(poses[e.source, :2], poses[e.target, :2])
                 for e in self.graph.edges]
        return nodes, edges
