"""Batches of chain and scan matches fanned out over a mesh axis.

Counterpart of the JAX package's ``parallel/sharded_match.py``. The
reference matches one chain at a time on one CPU thread
(range_scan_pose_graph.cpp:125-164). Here a batch of independent match
problems (back-end link candidates, loop-closure verifications, or plain
scans against one map) is split over the ``data`` axis: every rank is handed
the whole batch, matches its contiguous block of rows — rebuilding the chain
maps of those rows only — and the rows are gathered to every rank
(``Mesh.gather_rows``, one all-reduce of the packed (B, 13) rows). With
``mesh=None`` the whole batch runs in this process.

The JAX package partitions one ``vmap`` with shardings; the port's matchers
already carry a batch dimension where they can: ``chain_match`` batches the
chains of one scan against one centre, so the gather matcher sends its block
through one call. The rows of ``make_batched_chain_matcher`` each have their
own scan, ``n_valid`` and map centre, and those of
``make_batched_scan_matcher`` their own scan: the port's ``scan_match``
shares one scan across its batch, so these rows are matched one by one.
"""

from __future__ import annotations

import functools

import torch

from ..frontend.matchers import scan_match
from ..models.grid_map import ProbMap, ProbMapSpec, make_prob_map
from ..ops.raster import stamp_scan_batch
from .mesh import Mesh


def _block(mesh: Mesh | None, axis: str, batch: int) -> slice:
    """This rank's rows of a batch of ``batch``."""
    if mesh is None:
        return slice(0, batch)
    n, i = mesh.shape[axis], mesh.index[axis]
    if i < 0:
        raise ValueError("this rank is outside the mesh")
    if batch % n:
        raise ValueError(f"batch {batch} is not a multiple of the {axis} axis ({n})")
    b = batch // n
    return slice(i * b, (i + 1) * b)


def _gathered(mesh: Mesh | None, axis: str, batch: int, pose, score, cov):
    """(pose (B,3), score (B,), cov (B,3,3)) of the whole batch from this
    rank's rows: one all-reduce of the rows packed as pose(3) + score(1) +
    cov(9)."""
    if mesh is None:
        return pose, score, cov
    b = pose.shape[0]
    packed = torch.cat([pose.to(torch.float32), score.to(torch.float32)[:, None],
                        cov.to(torch.float32).reshape(b, 9)], dim=1).contiguous()
    rows = mesh.gather_rows(packed, batch, axis)
    return rows[:, :3], rows[:, 3], rows[:, 4:].reshape(batch, 3, 3)


def _host_ints(n_valid) -> list[int]:
    """Per-row valid-point counts as host ints (one read for a tensor): the
    port's matcher takes the count as an int."""
    if isinstance(n_valid, torch.Tensor):
        return [int(v) for v in n_valid.tolist()]
    return [int(v) for v in n_valid]


def _single_chain_match(spec_coarse: ProbMapSpec, spec_fine: ProbMapSpec,
                        matcher, use_blur_coarse: bool, use_blur_fine: bool,
                        chain_points, chain_masks, chain_poses, chain_valid,
                        points, mask, n_valid: int, init_pose, center_pose):
    """One row: maps centred on ``center_pose`` rebuilt from the chain,
    then the full match of the scan against them (no pub-map penalty)."""
    def recentered(pspec: ProbMapSpec) -> ProbMap:
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = torch.stack([-(center_pose[0] - 0.5 * size_x),
                           -(center_pose[1] - 0.5 * size_y)])
        return make_prob_map(pspec, off, chain_points.device)

    fine = stamp_scan_batch(spec_fine, recentered(spec_fine), chain_points,
                            chain_masks, chain_poses, chain_valid,
                            use_blur=use_blur_fine)
    # only the optimize matcher reads the coarse map
    coarse = ProbMap(None, None)
    if matcher.use_optimize_scan_match:
        coarse = stamp_scan_batch(spec_coarse, recentered(spec_coarse),
                                  chain_points, chain_masks, chain_poses,
                                  chain_valid, use_blur=use_blur_coarse)
    out = scan_match(matcher, spec_fine, fine.probs, fine.offset,
                     spec_coarse, coarse.probs, coarse.offset,
                     points, mask, n_valid, init_pose)
    return out.pose, out.score, out.cov


def batched_chain_match(spec_coarse: ProbMapSpec, spec_fine: ProbMapSpec,
                        matcher, use_blur_coarse: bool, use_blur_fine: bool,
                        chain_points, chain_masks, chain_poses, chain_valid,
                        points, mask, n_valid, init_pose, center_pose,
                        mesh: Mesh | None = None, axis: str = "data"):
    """(B,K,P,2), (B,K,P), (B,K,3), (B,K), (B,P,2), (B,P), (B,), (B,3), (B,3)
    -> poses (B,3), scores (B,), covs (B,3,3): each row's scan matched
    against maps rebuilt from its chain around its own centre. With a mesh,
    this rank matches its block of rows and the rows are gathered."""
    B = chain_points.shape[0]
    rows = range(B)[_block(mesh, axis, B)]
    nv = _host_ints(n_valid)
    outs = [_single_chain_match(spec_coarse, spec_fine, matcher, use_blur_coarse,
                                use_blur_fine, chain_points[r], chain_masks[r],
                                chain_poses[r], chain_valid[r], points[r], mask[r],
                                nv[r], init_pose[r], center_pose[r])
            for r in rows]
    pose, score, cov = (torch.stack(t) for t in zip(*outs))
    return _gathered(mesh, axis, B, pose, score, cov)


def make_batched_chain_matcher(spec_coarse: ProbMapSpec, spec_fine: ProbMapSpec,
                               matcher, use_blur_coarse: bool,
                               use_blur_fine: bool,
                               mesh: Mesh | None = None, axis: str = "data"):
    """Returns ``batched_chain_match`` with its specs, matcher and mesh
    bound: a function of the nine batched operands."""
    return functools.partial(batched_chain_match, spec_coarse, spec_fine, matcher,
                             use_blur_coarse, use_blur_fine, mesh=mesh, axis=axis)


def sharded_chain_match_gather(spec, all_points, all_masks, all_poses,
                               chain_ids, scan_id: int, n_valid: int,
                               init_poses, center_pose, pub_hits, pub_passes,
                               pub_offset, mesh: Mesh | None = None,
                               axis: str = "data"):
    """``backend.processor.chain_match_batch_gather`` with the (B, K) chain
    ids and the (B, 3) init poses split over ``axis``: this rank gathers and
    matches its block of chains from the store's buffers and the pub map,
    which every rank holds whole, so it builds only its block's chain maps.
    B must be a multiple of the axis size. Returns (pose (B,3), score (B,),
    cov (B,3,3)) on every rank."""
    from ..backend.processor import chain_match_batch_gather

    B = chain_ids.shape[0]
    rows = _block(mesh, axis, B)
    pose, score, cov = chain_match_batch_gather(
        spec, all_points, all_masks, all_poses, chain_ids[rows], scan_id, n_valid,
        init_poses[rows], center_pose, pub_hits, pub_passes, pub_offset)
    return _gathered(mesh, axis, B, pose, score, cov)


def make_sharded_chain_matcher_gather(spec, mesh: Mesh | None, axis: str = "data"):
    """Returns ``sharded_chain_match_gather`` with ``spec`` (a BackendSpec)
    and the mesh bound: call it with the operands of
    ``chain_match_batch_gather``. Ref workload: the LinkNearChains /
    TryCloseLoop chain fan-out, range_scan_pose_graph.cpp:125-164."""
    return functools.partial(sharded_chain_match_gather, spec, mesh=mesh, axis=axis)


def batched_scan_match(spec_fine: ProbMapSpec, spec_coarse: ProbMapSpec, matcher,
                       fine_probs, fine_off, coarse_probs, coarse_off,
                       points, mask, n_valid, init_pose,
                       mesh: Mesh | None = None, axis: str = "data"):
    """A batch of scans (B,P,2), (B,P), (B,), (B,3) matched against one map
    pyramid that every rank holds whole -> poses (B,3), scores (B,),
    covs (B,3,3)."""
    B = points.shape[0]
    rows = range(B)[_block(mesh, axis, B)]
    nv = _host_ints(n_valid)
    outs = []
    for r in rows:
        out = scan_match(matcher, spec_fine, fine_probs, fine_off, spec_coarse,
                         coarse_probs, coarse_off, points[r], mask[r], nv[r],
                         init_pose[r])
        outs.append((out.pose, out.score, out.cov))
    pose, score, cov = (torch.stack(t) for t in zip(*outs))
    return _gathered(mesh, axis, B, pose, score, cov)


def make_batched_scan_matcher(spec_fine: ProbMapSpec, spec_coarse: ProbMapSpec,
                              matcher, mesh: Mesh | None = None,
                              axis: str = "data"):
    """Returns ``batched_scan_match`` with its specs, matcher and mesh bound
    — the scans/sec throughput kernel and the loop-closure candidate
    prefilter: a function of the map pyramid and the batched scans."""
    return functools.partial(batched_scan_match, spec_fine, spec_coarse, matcher,
                             mesh=mesh, axis=axis)
