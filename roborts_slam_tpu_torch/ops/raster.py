"""Map rasterization ops: blur stamping, ray carving, batch rebuilds.

Counterpart of the JAX package's ``ops/raster.py`` (the reference's per-beam
serial Bresenham + per-cell blur stamping, occu_grid_map.h:125-329,531-576):

- Scan-match (prob) maps use only endpoint blur stamping (just_update_occu,
  slam_processor.cpp:495,510): a *max-merge* of a Gaussian stamp at each beam
  endpoint. Being a commutative max, chain-map rebuilds are one batched op.
- The pub (count) map carves free space along rays: each scan is rasterized
  into a per-scan mark image (free=1, occupied=2; occupied beats free, one
  update per cell per scan — the update_index_ rules of
  occu_grid_map.h:499-529), after which hit/pass counts update image-wise.
  On the card the mark image comes from the CUDA carve kernel
  (``ops/cuda/raycarve.cu``); ``mark_image_plain`` is its plain version.

Where the JAX package returns new immutable maps (and donates the old
buffers), the update functions here write the map tensors **in place** and
return the same container. JAX's ``mode="drop"`` scatters with index -1 have
no torch counterpart (-1 means "last element"): every scatter below masks
explicitly and sends dropped entries to cell 0 with a neutral value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.grid_map import (
    CountMap, CountMapSpec, LogOddsMap, ProbMap, ProbMapSpec, world_to_map_pose,
)
from ..utils.geometry import transform_points
from .cuda.raycarve import ray_mark_image


def _cell_round(x):
    """float map coords -> int cell, reference convention
    ``static_cast<int>(v + 0.5)`` for positive in-map coords
    (occu_grid_map.h:301-310)."""
    return torch.floor(x + 0.5).to(torch.int32)


def _scan_cells(inv_res: float, offset, points, mask, pose_world):
    """Sensor cell (...,2), endpoint cells (...,P,2) and the mask of beams
    whose endpoint differs from the sensor cell (occu_grid_map.h:312)."""
    pose_map = world_to_map_pose(offset, inv_res, pose_world)
    pts_map = transform_points(pose_map, points * inv_res)
    end = _cell_round(pts_map)
    start = _cell_round(pose_map[..., :2])
    same = torch.all(end == start[..., None, :], dim=-1)
    return start, end, mask & ~same


def endpoint_image(spec: ProbMapSpec, offset, points, mask, pose_world):
    """Scatter beam endpoints (world-frame scan at ``pose_world``) into a
    binary (H, W) indicator image. Beams whose endpoint cell equals the
    sensor cell are skipped (occu_grid_map.h:312)."""
    _, end, valid = _scan_cells(spec.inv_res, offset, points, mask, pose_world)
    end = end.to(torch.int64)
    valid = valid & (end[:, 0] >= 0) & (end[:, 0] < spec.width)
    valid = valid & (end[:, 1] >= 0) & (end[:, 1] < spec.height)
    flat = torch.where(valid, end[:, 1] * spec.width + end[:, 0], 0)
    img = torch.zeros((spec.height * spec.width,), dtype=torch.float32,
                      device=points.device)
    img.scatter_reduce_(0, flat, valid.to(torch.float32), "amax", include_self=True)
    return img.reshape(spec.height, spec.width)


def dilate_with_kernel(img, kernel: np.ndarray):
    """Grayscale dilation: out[y,x] = max_{dy,dx} img[y-dy, x-dx] * k[dy,dx]
    over the last two dims, as K*K shifted multiply-max passes on slices
    (K is small: 5 or 7 for the shipped sigma/resolution ratios)."""
    h = kernel.shape[0] // 2
    H, W = img.shape[-2:]
    out = torch.zeros_like(img)
    for dy in range(-h, h + 1):
        for dx in range(-h, h + 1):
            k = float(kernel[dy + h, dx + h])
            if k <= 0.0:
                continue
            dst = out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
            src = img[..., max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
            torch.maximum(dst, src * k, out=dst)
    return out


_STAMP_FOOTPRINTS: dict = {}    # (spec, device) -> (offsets (K²,2), values (K²,))


def _stamp_footprint(spec: ProbMapSpec, dev):
    """The blur kernel's cell offsets ``[dy, dx]`` and values on ``dev``,
    made once per (spec, device): a copy from host memory per stamp would
    wait for the device."""
    key = (spec, str(dev))
    if key not in _STAMP_FOOTPRINTS:
        h = spec.kernel_half
        offs = np.stack(np.meshgrid(np.arange(-h, h + 1), np.arange(-h, h + 1),
                                    indexing="ij"), -1).reshape(-1, 2)
        _STAMP_FOOTPRINTS[key] = (
            torch.as_tensor(offs, dtype=torch.int64, device=dev),
            torch.as_tensor(spec.blur_kernel().reshape(-1), dtype=torch.float32,
                            device=dev))
    return _STAMP_FOOTPRINTS[key]


def stamp_scan(spec: ProbMapSpec, pmap: ProbMap, points, mask, pose_world,
               use_blur: bool = True, gate=None) -> ProbMap:
    """Update a scan-match map with one scan (UpdateMapByRange with
    just_update_occu=true): max-merge the (blurred) endpoint stamp, as a
    sparse scatter-max of the kernel footprint around every endpoint
    (P x K x K values). Writes ``pmap.probs`` in place. ``gate`` (a () bool
    tensor): where it is false every value is dropped on the device and the
    map keeps its bits, with nothing read on the host."""
    _, end, valid = _scan_cells(spec.inv_res, pmap.offset, points, mask,
                                pose_world)
    dev = pmap.probs.device
    end = end.to(torch.int64)
    if gate is not None:
        valid = valid & gate
    if use_blur and spec.kernel_half > 0:
        offs, kvals = _stamp_footprint(spec, dev)
        cy = end[:, None, 1] + offs[:, 0]                               # (P, K²)
        cx = end[:, None, 0] + offs[:, 1]
        vals = kvals[None, :].expand(cy.shape)
    else:
        cy = end[:, 1:2]
        cx = end[:, 0:1]
        vals = torch.ones(cy.shape, dtype=torch.float32, device=dev)

    inb = (cx >= 0) & (cx < spec.width) & (cy >= 0) & (cy < spec.height)
    ok = inb & valid[:, None]
    flat = torch.where(ok, cy * spec.width + cx, 0)
    vals = torch.where(ok, vals, -math.inf)
    pmap.probs.view(-1).scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1),
                                        "amax", include_self=True)
    return pmap


def stamp_scan_batch(spec: ProbMapSpec, pmap: ProbMap, points_b, mask_b,
                     poses_b, scan_valid, use_blur: bool = True) -> ProbMap:
    """Rebuild/extend scan-match maps from batches of scans in one op.

    Because the update is a commutative max-merge, all scans' endpoints are
    scattered into one indicator image per map and dilated once (the
    reference loops InitMapWithRangeVec serially, occu_grid_map.h:222-255).
    ``points_b (...,K,P,2)``, ``mask_b (...,K,P)``, ``poses_b (...,K,3)``,
    ``scan_valid (...,K)`` masks padded chain slots; ``pmap.probs (...,H,W)``
    with the same leading batch dims (one map per back-end chain),
    ``pmap.offset`` shared ``(2,)`` or per map ``(...,2)``. Writes
    ``pmap.probs`` in place."""
    inv_res = spec.inv_res
    H, W = spec.height, spec.width
    lead = pmap.probs.shape[:-2]
    B = math.prod(lead)
    offset = pmap.offset if pmap.offset.dim() == 1 else pmap.offset[..., None, :]
    _, end, valid = _scan_cells(inv_res, offset, points_b,
                                mask_b & scan_valid[..., None], poses_b)
    end = end.to(torch.int64)
    valid = valid & (end[..., 0] >= 0) & (end[..., 0] < W)
    valid = valid & (end[..., 1] >= 0) & (end[..., 1] < H)
    flat = end[..., 1] * W + end[..., 0]                            # (...,K,P)
    flat = flat.reshape(B, -1) + torch.arange(B, device=flat.device)[:, None] * (H * W)
    valid = valid.reshape(B, -1)
    flat = torch.where(valid, flat, 0)
    img = torch.zeros((B * H * W,), dtype=torch.float32, device=flat.device)
    img.scatter_reduce_(0, flat.reshape(-1), valid.reshape(-1).to(torch.float32),
                        "amax", include_self=True)
    img = img.reshape(*lead, H, W)
    if use_blur and spec.kernel_half > 0:
        img = dilate_with_kernel(img, spec.blur_kernel())
    torch.maximum(pmap.probs, img, out=pmap.probs)
    return pmap


def _ray_cells(spec: CountMapSpec, start_cell, end_cells, beam_mask):
    """Cells along each beam via DDA line sampling.

    Returns (P, S) flat cell indices (−1 = invalid) and a (P, S) int mark
    value (1=free along ray, 2=occupied at endpoint). The cell sequence
    approximates Bresenham (occu_grid_map.h:125-188): identical start/end and
    4/8-connected midpoints that differ at most on diagonal tie-break cells.
    """
    return _ray_cells_hw(spec.max_ray_cells, spec.height, spec.width,
                         start_cell, end_cells, beam_mask)


def _ray_cells_hw(S: int, height: int, width: int, start_cell, end_cells,
                  beam_mask, t0: int = 0):
    """``_ray_cells`` for steps ``t0 .. t0 + S - 1`` on a ``height`` x
    ``width`` map."""
    start_cell = start_cell.to(torch.int64)
    end_cells = end_cells.to(torch.int64)
    delta = end_cells - start_cell[None, :]                       # (P,2) int
    nsteps = torch.clamp(torch.amax(torch.abs(delta), dim=-1), min=1)  # (P,) chebyshev
    t = torch.arange(t0, t0 + S, dtype=torch.int64, device=delta.device)[None, :]  # (1,S)
    # exact integer DDA: cell(t) = floor(start + delta*t/n + 1/2)
    #                            = (2n*start + 2*delta*t + n) // (2n)
    # (floor division; bit-identical to the CUDA carve kernel)
    n2 = (2 * nsteps)[:, None, None]                              # (P,1,1)
    num = (n2 * start_cell[None, None, :]
           + 2 * delta[:, None, :] * t[:, :, None] + nsteps[:, None, None])
    cells = torch.div(num, n2, rounding_mode="floor")             # (P,S,2)
    on_ray = t < nsteps[:, None]                                  # strictly before endpoint
    is_end = t == nsteps[:, None]
    valid = (on_ray | is_end) & beam_mask[:, None]
    inb = (
        (cells[..., 0] >= 0) & (cells[..., 0] < width)
        & (cells[..., 1] >= 0) & (cells[..., 1] < height)
    )
    valid = valid & inb
    flat = torch.where(valid, cells[..., 1] * width + cells[..., 0], -1)
    markv = torch.where(is_end, 2, 1) * valid.to(torch.int64)
    return flat, markv


def mark_image_plain(start, end, beam_mask, height: int, width: int):
    """Plain PyTorch version of the carve kernel, same arguments as
    ``ops.cuda.raycarve.ray_mark_image``: the scatter DDA over
    (P, max ray length + 1) candidate cells."""
    delta = end.to(torch.int64) - start.to(torch.int64)[None, :]
    # steps up to the longest ray's endpoint, sized from the data so that
    # every in-map cell of every ray is visited wherever the sensor lies;
    # 1024 steps at a time, which bounds the memory of a far-away sensor
    S = int(torch.clamp(torch.amax(torch.abs(delta)), min=1)) + 1 if end.numel() else 1
    img = torch.zeros((height * width,), dtype=torch.int32, device=start.device)
    for t0 in range(0, S, 1024):
        flat, markv = _ray_cells_hw(min(1024, S - t0), height, width, start, end,
                                    beam_mask, t0)
        # dropped entries (flat == -1) carry mark 0: send them to cell 0
        img.scatter_reduce_(0, torch.clamp(flat, min=0).reshape(-1),
                            markv.reshape(-1).to(torch.int32), "amax",
                            include_self=True)
    return img.reshape(height, width)


def scan_mark_image_plain(spec: CountMapSpec, offset, points, mask, pose_world):
    """Mark image through the plain version, whatever the device."""
    start, end, beam_mask = _scan_cells(spec.inv_res, offset, points, mask,
                                        pose_world)
    return mark_image_plain(start, end, beam_mask, spec.height, spec.width)


def scan_mark_image(spec: CountMapSpec, offset, points, mask, pose_world):
    """Per-scan mark image: 0 untouched, 1 free (ray pass-through),
    2 occupied (beam endpoint). Occupied wins over free, matching the
    update_index_ rules (occu_grid_map.h:499-529). Through the kernel
    wrapper: the CUDA carve kernel on the card, the plain version for CPU
    tensors."""
    start, end, beam_mask = _scan_cells(spec.inv_res, offset, points, mask,
                                        pose_world)
    return ray_mark_image(start.contiguous(), end.contiguous(),
                          beam_mask.contiguous(), spec.height, spec.width)


def update_log_odds_map(spec: CountMapSpec, lmap: LogOddsMap, points, mask,
                        pose_world, free_prob: float = 0.3,
                        occu_prob: float = 0.9) -> LogOddsMap:
    """Log-odds pub-map update for one scan (LogOddsCellFunctions,
    grid_map_cell.h:205-235): pass-through cells add log-odds(free_prob),
    endpoint cells add log-odds(occu_prob); per-scan idempotence comes from
    the mark image (occupied wins over free on the same cell), which on the
    card is the carve kernel's. Writes ``lmap.log_odds`` in place."""
    mark = scan_mark_image(spec, lmap.offset, points, mask, pose_world)
    lo_free = float(np.log(free_prob / (1.0 - free_prob)))
    lo_occu = float(np.log(occu_prob / (1.0 - occu_prob)))
    delta = torch.where(mark == 2, lo_occu, torch.where(mark == 1, lo_free, 0.0))
    lmap.log_odds.add_(delta.to(torch.float32))
    return lmap


def update_count_map(spec: CountMapSpec, cmap: CountMap, points, mask,
                     pose_world, free_factor, occu_factor, gate=None) -> CountMap:
    """Pub-map update for one scan (CountCellFunctions, grid_map_cell.h:94-111):
    per touched cell: pass += 1+free_factor; endpoint cells additionally
    hit += 1+occu_factor. Writes ``cmap.hits`` / ``cmap.passes`` in place.
    ``gate`` (a () bool tensor) multiplies both increments: where it is
    false the mark image is still computed and zeros are added, so the
    counts keep their bits, with nothing read on the host."""
    mark = scan_mark_image(spec, cmap.offset, points, mask, pose_world)
    touched = (mark > 0).to(torch.float32)
    occu = (mark == 2).to(torch.float32)
    occu_inc = 1.0 + occu_factor
    free_inc = 1.0 + free_factor
    if gate is not None:
        on = gate.to(torch.float32)
        occu_inc, free_inc = occu_inc * on, free_inc * on
    cmap.hits.add_(occu * occu_inc)
    cmap.passes.add_(touched * free_inc)
    return cmap


def rebuild_count_map(spec: CountMapSpec, cmap_offset, points_b, mask_b,
                      poses_b, scan_valid, free_factor, occu_factor,
                      first_scan_extra: int = 0) -> CountMap:
    """Rebuild the pub map from scratch over a batch of scans.

    Count updates are additive and commute; the rebuild is a Python loop of
    per-scan mark images folded into fresh hit/pass planes (one mark image
    per scan, so per-scan idempotence holds) — the equivalent of
    CorrectPoseAndMap's InitMapWithRangeVec rebuild
    (slam_processor.cpp:350-356), including the quirk of re-applying scan 0
    ``min_passthrough`` extra times (:351-353)."""
    dev = points_b.device
    out = CountMap(
        hits=torch.zeros((spec.height, spec.width), dtype=torch.float32, device=dev),
        passes=torch.zeros((spec.height, spec.width), dtype=torch.float32, device=dev),
        offset=torch.as_tensor(cmap_offset, dtype=torch.float32, device=dev),
    )
    for i in range(points_b.shape[0]):
        update_count_map(spec, out, points_b[i], mask_b[i] & scan_valid[i],
                         poses_b[i], free_factor, occu_factor)
    for _ in range(first_scan_extra):
        update_count_map(spec, out, points_b[0], mask_b[0], poses_b[0],
                         free_factor, occu_factor)
    return out
