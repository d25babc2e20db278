"""The correction rebuild's count kernel (K7, ``ops/cuda/rebuild.py``) held
against its plain version (``ops/raster.py::rebuild_counts_plain``, the
loop of one carve a slot) on the card, on the same inputs: the scenes, the
comparison and two faulty readings that show the comparison bites.

A scene is a store's rows as the engine's mirror holds them: ``B`` slots of
``P`` point slots (the first ``beams`` real, 270° at 10 m, 6 % of returns
dropped), the first ``valid`` slots scans taken round the corridor loop of
the benchmark's traffic (a 24 m x 16 m hall round an 18 m x 10 m block,
ray-cast on the host) and the rest padding rows that hold other scans, as a
mirror may. ``edge_cells`` adds the cases a log rarely has: a sensor off
the map, rays that leave the map on both sides, a fan of beams into one
cell, rays long enough for the kernel's 64-bit walk.

The kernel must equal the loop bit for bit: ``compare`` counts the cells
of either plane that differ and whether a second call repeats the first.
``faulty_readings`` counts the cells where two wrong kernels differ from
the loop: one without the per-scan rule (every beam a scan of its own, so a
cell is counted once a beam), one that turns a count into ``count * c``
instead of the sequential sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.grid_map import CountMapSpec
from ..ops import raster
from ..ops.cuda import rebuild

HALL = (12.0, 8.0)        # half sizes of the hall (m)
BLOCK = (9.0, 5.0)        # ... of the block inside it
LOOP = (10.5, 6.5)        # half sizes of the path round the corridor
RANGE_MAX = 10.0
FACTORS = (0.3, 0.7)      # free and occupied update factors of every profile
EXTRA = 3                 # map_min_passthrough of every profile


def pub_spec(side: int, resolution: float = 0.05) -> CountMapSpec:
    """A ``side``² pub map of the profiles' resolution, centred on the loop."""
    return CountMapSpec(resolution=resolution, height=side, width=side,
                        max_ray_cells=int(RANGE_MAX / resolution) + 2, carve_window=0)


def _walls():
    """The hall's and the block's eight walls as segments (x0, y0, x1, y1)."""
    out = []
    for hx, hy in (HALL, BLOCK):
        c = [(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)]
        out += [(*c[i], *c[(i + 1) % 4]) for i in range(4)]
    return np.array(out, np.float64)


def _ranges(origin, angles):
    """The first wall each ray from ``origin`` (R, 2) at ``angles`` (R, A)
    meets, or inf."""
    d = np.stack([np.cos(angles), np.sin(angles)], -1)             # (R, A, 2)
    best = np.full(angles.shape, np.inf)
    for x0, y0, x1, y1 in _walls():
        e = np.array([x1 - x0, y1 - y0])
        w = np.array([x0, y0]) - origin[:, None, :]                # (R, 1, 2)
        den = d[..., 0] * e[1] - d[..., 1] * e[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (w[..., 0] * e[1] - w[..., 1] * e[0]) / den
            u = (w[..., 0] * d[..., 1] - w[..., 1] * d[..., 0]) / den
        hit = (np.abs(den) > 1e-12) & (t > 1e-6) & (u >= 0) & (u <= 1)
        best = np.where(hit, np.minimum(best, t), best)
    return best


def corridor_rows(B: int, valid: int, seed: int, P: int = 1152, beams: int = 1081):
    """A store's rows: points (B, P, 2) in the scan's frame, masks (B, P),
    poses (B, 3) in the world, slot_valid (B,) (the first ``valid``), as
    numpy arrays; every slot a scan at a pose round the loop."""
    rng = np.random.default_rng(seed)
    legs = (2 * LOOP[0], 2 * LOOP[1], 2 * LOOP[0], 2 * LOOP[1])
    heading = ((1, 0), (0, 1), (-1, 0), (0, -1))
    # stored scans in the order of 3.15 laps; the padding rows anywhere
    along = np.sort(rng.uniform(0.0, 3.15, B))
    rng.shuffle(along[valid:])
    xy = np.empty((B, 2))
    for i, lap in enumerate(along):
        a = (lap % 1.0) * sum(legs)
        x, y = -LOOP[0], -LOOP[1]
        for leg, (dx, dy) in zip(legs, heading):
            step = min(a, leg)
            x, y, a = x + dx * step, y + dy * step, a - step
        xy[i] = (x, y)
    xy += rng.normal(0, 0.3, xy.shape)
    theta = rng.uniform(-np.pi, np.pi, B)
    local = np.linspace(-0.75 * np.pi, 0.75 * np.pi, beams)
    r = _ranges(xy, theta[:, None] + local[None, :])
    r = r + rng.normal(0, 0.01, r.shape)
    ok = np.isfinite(r) & (r < RANGE_MAX) & (rng.random(r.shape) > 0.06)
    r = np.where(ok, r, 0.0)
    pts = np.zeros((B, P, 2), np.float32)
    mask = np.zeros((B, P), bool)
    pts[:, :beams] = np.stack([r * np.cos(local), r * np.sin(local)], -1)
    mask[:, :beams] = ok
    poses = np.concatenate([xy, theta[:, None]], 1).astype(np.float32)
    return pts, mask, poses, np.arange(B) < valid


def cells(spec: CountMapSpec, rows, device):
    """``rebuild_counts``'s arguments but the planes and factors, as
    ``rebuild_count_map`` computes them from a store's rows: (start, end,
    beam_mask, slot_valid) and scan 0's cells."""
    pts, mask, poses, sv = (torch.as_tensor(x, device=device) for x in rows)
    off = torch.full((2,), spec.height * spec.resolution / 2, device=device)
    batch = raster._scan_cells(spec.inv_res, off, pts, mask, poses)
    first = raster._scan_cells(spec.inv_res, off, pts[0], mask[0], poses[0])
    return ([t.contiguous() for t in batch] + [sv.contiguous()],
            tuple(t.contiguous() for t in first))


def edge_cells(args, first, H: int, W: int):
    """The same arguments with the cases a log rarely has: slot 1's sensor
    off the map (below and left of it), slot 2's first beams long enough for
    the 64-bit walk (40,000 cells and more) and one leaving past the top
    corner, slot 3's valid beams all into one cell, slot 4's rays leaving
    the map on the right; scan 0's extra slot gets a long ray too."""
    start, end, beams, sv = (t.clone() for t in args)
    cell = lambda x, y: torch.tensor([x, y], dtype=torch.int32, device=start.device)
    if start.shape[0] >= 5:
        start[1] = cell(-40, -25)
        end[2, 0] = start[2] + cell(40000, 7)
        end[2, 1] = start[2] - cell(3, 33000)
        end[2, 2] = cell(W + 5, H + 9)
        beams[2, :3] = True
        end[3] = start[3] + cell(17, -11)
        end[4, :, 0] += W
        sv[1:5] = True
    s0, e0, m0 = (t.clone() for t in first)
    e0[0] = s0 + cell(-35000, 20)
    m0[0] = True
    return [start, end, beams, sv], (s0, e0, m0)


def planes(H: int, W: int, device):
    """Two planes holding something the call must overwrite."""
    return (torch.full((H, W), 7.0, device=device), torch.full((H, W), 7.0, device=device))


def compare(args, first, H: int, W: int, extra: int = EXTRA) -> dict:
    """K7 and the plain loop on the same arguments: the cells of each plane
    that differ, whether a second call repeats the first bit for bit, and
    the cells the loop marks."""
    dev = args[0].device
    got = planes(H, W, dev)
    rebuild.rebuild_counts(*args, *got, *FACTORS, extra, first)
    again = planes(H, W, dev)
    rebuild.rebuild_counts(*args, *again, *FACTORS, extra, first)
    want = planes(H, W, dev)
    raster.rebuild_counts_plain(*args, *want, *FACTORS, extra, first)
    return {"shape": [int(args[1].shape[0]), int(args[1].shape[1]), H, W],
            "valid_slots": int(args[3].sum()),
            "hits_cells_differing": int((got[0] != want[0]).sum()),
            "passes_cells_differing": int((got[1] != want[1]).sum()),
            "repeats_its_bits": bool(torch.equal(got[0], again[0])
                                     and torch.equal(got[1], again[1])),
            "cells_marked": int((want[1] > 0).sum()),
            "largest_pass_count": float(want[1].max())}


def held(r: dict) -> bool:
    """Whether a reading is the loop's bit for bit."""
    return (r["repeats_its_bits"] and r["hits_cells_differing"] == 0
            and r["passes_cells_differing"] == 0 and r["cells_marked"] > 0)


def faulty_readings(args, first, H: int, W: int, extra: int = EXTRA) -> dict:
    """Cells differing from the loop under two faulty kernels: ``no_dedup``
    (K7 with every beam a slot of its own, scan 0's beams ``extra`` more
    times: a cell counted once a beam), ``count_times_c`` (K7's counts,
    read back through its table, turned into ``count * c``)."""
    start, end, beams, sv = args
    dev = start.device
    B, P = beams.shape
    want = planes(H, W, dev)
    raster.rebuild_counts_plain(*args, *want, *FACTORS, extra, first)
    s0, e0, m0 = first
    one = torch.cat([start.repeat_interleave(P, 0), s0.repeat(extra * P, 1)])
    ends = torch.cat([end.reshape(B * P, 1, 2), e0.repeat(extra, 1).reshape(-1, 1, 2)])
    mask = torch.cat([(beams & sv[:, None]).reshape(B * P, 1), m0.repeat(extra)[:, None]])
    spoilt = planes(H, W, dev)
    rebuild.rebuild_counts(one.contiguous(), ends.contiguous(), mask.contiguous(),
                           torch.ones(one.shape[0], dtype=torch.bool, device=dev),
                           *spoilt, *FACTORS)
    got = planes(H, W, dev)
    rebuild.rebuild_counts(*args, *got, *FACTORS, extra, first)
    times = []
    for plane, factor in zip(got, (FACTORS[1], FACTORS[0])):
        table = rebuild.count_table(1.0 + factor, B + extra + 1).to(dev)
        count = torch.searchsorted(table, plane)
        times.append(count.to(torch.float32) * torch.tensor(np.float32(1.0 + factor),
                                                            device=dev))
    differing = lambda a, b: int(((a[0] != b[0]) | (a[1] != b[1])).sum())
    return {"no_dedup": differing(spoilt, want), "count_times_c": differing(times, want)}
