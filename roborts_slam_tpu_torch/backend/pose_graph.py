"""Pose-graph construction + Karto-style loop closure (host-side logic).

Own copy of the JAX package's ``backend/pose_graph.py`` (``RangeScanPoseGraph``
/ ``PoseGraph``, src/pose_graph/{pose_graph.h, range_scan_pose_graph.{h,cpp}}).
The graph bookkeeping (ids, adjacency, chains) is irregular and tiny — it
stays in Python/NumPy on the host — while every heavy step (chain-map rebuild
+ matching, the SPA solve) runs on the device. Every public method holds one
re-entrant lock: in the fused asynchronous mode the front end's chain
pre-discovery (``find_*_for_new``, which adds hypothetical vertices for the
time of one query) runs while the back-end worker updates the graph.

Chain semantics replicated from the reference:
- ``find_near_linked_scans``: BFS over graph edges keeping scans whose
  barycenter is within link_scan_max_distance (range_scan_pose_graph.cpp:272-297).
- ``find_near_chains``: expand each near scan into a contiguous-id chain,
  invalid if it touches the current scan (:207-270).
- sparsify chains to <= 10 ids by stride 2 (:130-144).
- ``find_possible_loop_closure``: linear scan over all older scans for
  nearby chains not graph-linked to the current scan (:357-392).
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np


def _locked(method):
    """Run ``method`` under the graph's lock, so that each public operation
    is atomic against the other thread; discovery racing the worker then
    changes only the fused hit rate (the set-equality check where the
    chain rows are consumed), never the graph."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return wrapper


def _pose_relative_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Relative pose of b in a's frame (a^-1 (+) b) — pure NumPy float64.

    Same construction as utils.geometry.pose_relative (the reference's
    TransformByMidFrame, pose_graph.h:88-107), but host-side: graph edges
    are built on the host per accepted scan in float64."""
    ca, sa = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    th = b[2] - a[2]
    return np.array([ca * dx + sa * dy, -sa * dx + ca * dy,
                     np.arctan2(np.sin(th), np.cos(th))])


@dataclasses.dataclass
class GraphEdge:
    source: int
    target: int
    rel_pose: np.ndarray       # (3,) relative pose of target in source frame
    information: np.ndarray    # (3,3)


class PoseGraph:
    """Undirected scan graph over scan ids (= vertex ids, append-only)."""

    def __init__(self, link_scan_max_distance: float,
                 loop_match_min_chain_size: int):
        self.link_scan_max_distance = link_scan_max_distance
        self.loop_match_min_chain_size = loop_match_min_chain_size
        self.adjacency: list[set] = []
        self.edges: list[GraphEdge] = []
        self._edge_set: set = set()
        self._lock = threading.RLock()

    @property
    def num_vertices(self) -> int:
        return len(self.adjacency)

    @_locked
    def add_vertex(self) -> int:
        self.adjacency.append(set())
        return len(self.adjacency) - 1

    @_locked
    def has_edge(self, i: int, j: int) -> bool:
        return (min(i, j), max(i, j)) in self._edge_set

    @_locked
    def add_edge(self, source: int, target: int, source_pose, target_pose,
                 covariance) -> bool:
        """Add a constraint if absent (AddEdge, range_scan_pose_graph.cpp:80-100).
        Link info per EdgeLinkInfo (pose_graph.h:88-107): relative pose via
        the mid-frame transform; covariance rotated into the source frame and
        inverted into an information matrix
        (ceres_pose_graph_solver.cpp:144-176)."""
        key = (min(source, target), max(source, target))
        if key in self._edge_set:
            return False
        rel = _pose_relative_host(np.asarray(source_pose, np.float64),
                                  np.asarray(target_pose, np.float64))
        th = float(source_pose[2])
        c, s = np.cos(-th), np.sin(-th)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        cov = rot @ np.asarray(covariance, np.float64) @ rot.T
        info = np.linalg.inv(cov + 1e-12 * np.eye(3))
        self.edges.append(GraphEdge(source, target, rel, info))
        self._edge_set.add(key)
        self.adjacency[source].add(target)
        self.adjacency[target].add(source)
        return True

    # ---- traversal / chain discovery (all NumPy over barycenters) ----

    def _near_mask(self, scan_id: int, barycenters: np.ndarray,
                   strict: bool) -> np.ndarray:
        """Vectorized distance gate: one pass over the (N, 2) barycenter
        array instead of a python-scalar test per vertex."""
        center = barycenters[scan_id, :2]
        d2 = np.sum((barycenters[:, :2] - center[None]) ** 2, axis=1)
        max_d2 = self.link_scan_max_distance**2
        return (d2 < max_d2) if strict else (d2 <= max_d2)

    @_locked
    def find_near_linked_scans(self, scan_id: int, barycenters: np.ndarray
                               ) -> list[int]:
        """BFS keeping vertices within link_scan_max_distance of scan_id's
        barycenter (FindNearLinkedScans + NearScanVisitor,
        range_scan_pose_graph.cpp:272-297)."""
        near = self._near_mask(scan_id, barycenters, strict=False)
        visited = {scan_id}
        out = []
        queue = [scan_id]
        while queue:
            v = queue.pop(0)
            if near[v]:
                out.append(v)
                for nb in self.adjacency[v]:
                    if nb not in visited:
                        visited.add(nb)
                        queue.append(nb)
        return out

    @_locked
    def find_near_chains(self, scan_id: int, barycenters: np.ndarray
                         ) -> list[list[int]]:
        """FindNearChainsIds (range_scan_pose_graph.cpp:207-270)."""
        near_m = self._near_mask(scan_id, barycenters, strict=True)
        near = self.find_near_linked_scans(scan_id, barycenters)
        processed = set()
        chains = []
        n = self.num_vertices
        for near_id in near:
            if near_id == scan_id or near_id in processed:
                continue
            processed.add(near_id)
            valid = True
            chain = []
            for cand in range(near_id - 1, -1, -1):
                if cand == scan_id:
                    valid = False
                if near_m[cand]:
                    chain.insert(0, cand)
                    processed.add(cand)
                else:
                    break
            chain.append(near_id)
            for cand in range(near_id + 1, n):
                if cand == scan_id:
                    valid = False
                if near_m[cand]:
                    chain.append(cand)
                    processed.add(cand)
                else:
                    break
            if valid:
                chains.append(chain)
        return chains

    def _with_hypothetical_vertex(self, fn, k: int = 1):
        """Run ``fn()`` with the next ``k`` vertices (ids num_vertices ..
        num_vertices+k-1) and their odometry edges to their predecessors
        present for the time of the call. ``k > 1`` serves the pipelined
        fetch: in-flight scans, whose acceptance is not known yet, are taken
        as kept for the chain pre-discovery (the set-equality check where
        the rows are consumed catches any divergence)."""
        base = self.num_vertices
        for j in range(k):
            new_id = base + j
            prev = new_id - 1
            self.adjacency.append({prev} if prev >= 0 else set())
            if prev >= 0:
                self.adjacency[prev].add(new_id)
        try:
            return fn()
        finally:
            for j in reversed(range(k)):
                new_id = base + j
                prev = new_id - 1
                self.adjacency.pop()
                if prev >= 0:
                    self.adjacency[prev].discard(new_id)

    @_locked
    def find_all_loop_candidates_for_new(self, barycenters_with_new: np.ndarray,
                                         k: int = 1) -> list[list[int]]:
        """TryCloseLoop's first-round chain set for the next vertex as it will
        be discovered after that scan's UpdateGraph, from the hypothetical
        barycenter rows (cf. ``find_near_chains_for_new``). ``k``: the
        hypothetical vertices (pending pipelined scans, then the new one)."""
        new_id = self.num_vertices + k - 1
        if new_id == 0:
            return []
        return self._with_hypothetical_vertex(
            lambda: self.find_all_loop_candidates(new_id, barycenters_with_new), k)

    @_locked
    def find_near_chains_for_new(self, barycenters_with_new: np.ndarray,
                                 k: int = 1) -> list[list[int]]:
        """Chain discovery for the next vertex (id ``num_vertices + k - 1``)
        as it will run inside UpdateGraph — the vertex added and the odometry
        edge to its predecessor present (range_scan_pose_graph.cpp:44-78) —
        without changing the committed graph: the fused step matches these
        chains before the scan is kept, and the consumer runs the real
        discovery afterwards and matches again where the sets differ.
        ``barycenters_with_new``: (n+k, 3), the committed barycenters and one
        row per hypothetical vertex (``k - 1`` pending pipelined scans, then
        the new scan)."""
        new_id = self.num_vertices + k - 1
        if new_id == 0:
            return []
        return self._with_hypothetical_vertex(
            lambda: self.find_near_chains(new_id, barycenters_with_new), k)

    @staticmethod
    def sparsify_chain(chain: list[int], limit: int = 10) -> list[int]:
        """Stride-2 sparsification to <= limit+1 ids
        (range_scan_pose_graph.cpp:130-144)."""
        if len(chain) <= limit:
            return list(chain)
        out = []
        for i, cid in enumerate(chain):
            if i % 2 == 0:
                out.append(cid)
            if len(out) > limit:
                break
        return out

    @_locked
    def find_possible_loop_closure(self, scan_id: int, barycenters: np.ndarray,
                                   start_id: int) -> tuple[list[int], int]:
        """FindPossibleLoopClosure (range_scan_pose_graph.cpp:357-392):
        returns (chain, next_start_id). Vectorized run-walk over the near
        mask — identical to the reference's per-candidate loop: near cells
        accumulate a chain, a near-but-graph-linked cell resets it, a far
        cell terminates it (returned if >= min chain size)."""
        n = scan_id  # scans_num = current_data_index (scans before current)
        if start_id >= n:
            return [], n
        near_m = self._near_mask(scan_id, barycenters, strict=True)[:n]
        linked = np.zeros(n, bool)
        for v in self.find_near_linked_scans(scan_id, barycenters):
            if v < n:
                linked[v] = True

        # a returned chain is a maximal contiguous run of candidate cells
        # (near & not graph-linked) terminated by a FAR cell or the array
        # end; a run terminated by a linked-near cell is discarded (the
        # reference resets the chain without a length check there)
        cand = near_m & ~linked
        pos = start_id
        while pos < n:
            rest = cand[pos:]
            if not rest.any():
                return [], n
            a = pos + int(np.argmax(rest))                 # run start
            after = ~cand[a:]
            b = a + int(np.argmax(after)) if after.any() else n  # run end
            if (b - a >= self.loop_match_min_chain_size
                    and (b >= n or not near_m[b])):
                return list(range(a, b)), b + 1
            pos = b + 1
        return [], n

    @_locked
    def find_all_loop_candidates(self, scan_id: int, barycenters: np.ndarray
                                 ) -> list[list[int]]:
        """All candidate loop chains for a scan in one pass (the batched
        verification path matches them together instead of one by one)."""
        chains = []
        start = 0
        while True:
            chain, start = self.find_possible_loop_closure(
                scan_id, barycenters, start)
            if not chain:
                return chains
            chains.append(chain)

    @staticmethod
    def find_closest_scan_id(chain: list[int], scan_id: int,
                             barycenters: np.ndarray) -> int:
        """FindClosestRangeScanId (range_scan_pose_graph.cpp:192-205)."""
        c = barycenters[scan_id, :2]
        ids = np.asarray(chain)
        d2 = np.sum((barycenters[ids, :2] - c[None]) ** 2, axis=1)
        return int(ids[np.argmin(d2)])

    @_locked
    def as_solver_data(self, poses: np.ndarray, device):
        """Pack the graph into PoseGraphData tensors on ``device`` for the
        SPA solver. Unpadded: there is no compilation to amortise."""
        import torch

        from .spa import PoseGraphData

        n = self.num_vertices
        e = len(self.edges)
        eij = np.zeros((e, 2), np.int64)
        erel = np.zeros((e, 3), np.float32)
        einfo = np.zeros((e, 3, 3), np.float32)
        for k, edge in enumerate(self.edges):
            eij[k] = (edge.source, edge.target)
            erel[k] = edge.rel_pose
            einfo[k] = edge.information
        t = lambda a: torch.as_tensor(a, device=device)
        return PoseGraphData(
            poses=t(np.asarray(poses[:n], np.float32)),
            node_mask=t(np.ones(n, bool)), edge_ij=t(eij), edge_rel=t(erel),
            edge_info=t(einfo), edge_mask=t(np.ones(e, bool)),
        )
