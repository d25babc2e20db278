"""Wrappers of the ray carving / ray checking CUDA kernels (``raycarve.cu``).

Each wrapper launches its kernel for tensors on the card and takes the plain
PyTorch version (``ops.raster.mark_image_plain`` /
``ops.raycast.bad_rays_plain``) only for CPU tensors. There is no fallback:
on a CUDA tensor it launches the kernel or raises.

A combination of shapes, dtypes and devices is validated once and looked up
afterwards (contiguity is checked at every call); the outputs come from
``torch.empty``, since the kernels write every element.

What the kernels' index arithmetic rests on is stated here in plain PyTorch,
for the CPU tests: the stepped DDA (``dda_stepped``), the test that sends a
ray to the 64-bit path (``needs_wide``), the beam-major carve
(``mark_image_beams``), the tile-major carve's tiles and the steps of a beam
inside a tile (``tile_plan``, ``tile_steps``, ``mark_image_tiled``), the
check's blocks and scratch (``check_geometry``) and its walk
(``bad_rays_stepped``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch

from . import build, launch

mark_launches = 0     # ray_mark_image kernel launches so far
check_launches = 0    # bad_ray_count kernel launches so far
# the same launches by shape: (beams, H, W) and (B, rays, H, W) -> count
mark_shapes: collections.Counter = collections.Counter()
check_shapes: collections.Counter = collections.Counter()

NARROW_MAX_N = 32767            # kNarrowMaxN of raycarve.cu: 2n² + 3n < 2³¹
NARROW_MAX_COORD = 1 << 30      # kNarrowMaxCoord
# carve designs (``design`` of raycarve.cu's geometry)
BEAM_MAJOR = 0          # a fill kernel, and a warp per beam that starts while it runs
TILE_MAJOR = 1          # a block per tile of the image in shared memory, one launch
BEAM_MAJOR_MEMSET = 2   # cudaMemsetAsync, then a warp per beam
BEAM_MAJOR_LOOK = 3     # cudaMemsetAsync, 16 lanes per beam, a load before each atomic
MARK_DESIGNS = {"beam_major": BEAM_MAJOR, "tile_major": TILE_MAJOR,
                "beam_major_memset": BEAM_MAJOR_MEMSET, "beam_major_look": BEAM_MAJOR_LOOK}
MARK_DESIGN = BEAM_MAJOR        # the design ``ray_mark_image`` launches
TILE = (32, 32, 256)            # tile rows, tile columns, threads of the tile-major design
CHECK_WARPS = 4                 # kCheckWarps: rays per block of the check
CHECK_ROUNDS = 8                # kCheckRounds: steps a lane keeps in flight
MAX_GRID_Y = 65535

_fns: dict[str, object] = {}
_mark_plans: dict[tuple, "_MarkPlan"] = {}
_check_plans: dict[tuple, "_CheckPlan"] = {}
_tickets: dict[int, object] = {}    # device index -> the check's scratch


class _CheckParams(ctypes.Structure):
    """``CheckParams`` of raycarve.cu."""

    _fields_ = [("B", ctypes.c_int), ("S", ctypes.c_int), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("groups", ctypes.c_int),
                ("ticket", ctypes.c_int), ("thr_d2", ctypes.c_int),
                ("min_passthrough", ctypes.c_float),
                ("occu_threshold", ctypes.c_float)]


_MARK_FN = ("ray_mark_image_launch", 6)      # symbol, pointer arguments
_CHECK_FN = ("bad_ray_count_launch", 9)


def _launcher(symbol: str, pointers: int):
    """The bound C function (the library is built at the first call)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load("raycarve"), symbol)
        fn.argtypes = [ctypes.c_void_p] * pointers       # the stream included
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


@dataclasses.dataclass(frozen=True)
class _MarkPlan:
    """What a carve at one validated combination of shapes, dtypes and
    devices needs, computed once."""

    geometry: object          # ctypes int array: P, H, W, design
    geometry_ptr: int
    out_shape: tuple          # (H, W)
    index: int                # the device's index
    count_key: tuple          # key into ``mark_shapes``


@dataclasses.dataclass(frozen=True)
class _CheckPlan:
    """The same for the ray check; the three scalars belong to the
    combination."""

    params: object            # a _CheckParams
    params_ptr: int
    tickets: object           # scratch of the device, kept alive here
    tickets_ptr: int
    out_shape: tuple          # (B,)
    index: int
    count_key: tuple          # key into ``check_shapes``


def _keep(plans: dict, key, plan):
    if len(plans) >= 1024:            # an engine sees a handful of combinations
        plans.clear()
    plans[key] = plan
    return plan


def _mark_plan(start, end, beam_mask, height: int, width: int, design: int) -> _MarkPlan:
    key = (start.shape, end.shape, beam_mask.shape, start.dtype, end.dtype,
           beam_mask.dtype, start.device, end.device, beam_mask.device,
           height, width, design)
    plan = _mark_plans.get(key)
    if plan is None:
        dev = start.device
        if end.dim() != 2:
            raise ValueError("ray_mark_image: start (2,), end (P,2), beam_mask (P,)")
        P = end.shape[0]
        build.check_tensor("start", start, torch.int32, (2,), dev)
        build.check_tensor("end", end, torch.int32, (P, 2), dev)
        build.check_tensor("beam_mask", beam_mask, torch.bool, (P,), dev)
        if design not in MARK_DESIGNS.values():
            raise ValueError(f"ray_mark_image: no design {design}")
        if height < 0 or width < 0 or -(-height // TILE[0]) > MAX_GRID_Y:
            raise ValueError(f"ray_mark_image: a {height} x {width} image")
        geometry = (ctypes.c_int * 4)(P, height, width, design)
        plan = _keep(_mark_plans, key, _MarkPlan(
            geometry, ctypes.addressof(geometry), (height, width), dev.index,
            (P, height, width)))
    if not (start.is_contiguous() and end.is_contiguous()
            and beam_mask.is_contiguous()):
        raise ValueError("ray_mark_image: every argument must be contiguous")
    return plan


def _tickets_for(dev, poses: int):
    """The check kernel's scratch on ``dev``: a 64-bit word per pose, 0
    between launches (zeroed here once, when made). It serves one stream at a
    time."""
    held = _tickets.get(dev.index)
    if held is None or held.numel() < poses:
        held = _tickets[dev.index] = torch.empty((max(poses, 64),), dtype=torch.int64,
                                                 device=dev).zero_()
    return held


def _check_plan(start, end, ray_ok, hits, passes, min_passthrough, occu_threshold,
                thr_d2, ticket: bool = True) -> _CheckPlan:
    key = (start.shape, end.shape, ray_ok.shape, hits.shape, passes.shape,
           start.dtype, end.dtype, ray_ok.dtype, hits.dtype, passes.dtype,
           start.device, end.device, ray_ok.device, hits.device, passes.device,
           min_passthrough, occu_threshold, thr_d2, ticket)
    plan = _check_plans.get(key)
    if plan is None:
        dev = start.device
        if ray_ok.dim() != 2 or hits.dim() != 2:
            raise ValueError("bad_ray_count: start (B,2), end (B,S,2), ray_ok (B,S), "
                             "hits and passes (H,W)")
        B, S = ray_ok.shape
        H, W = hits.shape
        build.check_tensor("start", start, torch.int32, (B, 2), dev)
        build.check_tensor("end", end, torch.int32, (B, S, 2), dev)
        build.check_tensor("ray_ok", ray_ok, torch.bool, (B, S), dev)
        build.check_tensor("hits", hits, torch.float32, (H, W), dev)
        build.check_tensor("passes", passes, torch.float32, (H, W), dev)
        if H < 1 or W < 1:
            raise ValueError(f"bad_ray_count: a {H} x {W} map")
        g = check_geometry(B, S)
        params = _CheckParams(B, S, H, W, g.groups, int(ticket), int(thr_d2),
                              float(min_passthrough), float(occu_threshold))
        tickets = _tickets_for(dev, g.tickets)
        plan = _keep(_check_plans, key, _CheckPlan(
            params, ctypes.addressof(params), tickets, tickets.data_ptr(),
            (B,), dev.index, (B, S, H, W)))
    if not (start.is_contiguous() and end.is_contiguous() and ray_ok.is_contiguous()
            and hits.is_contiguous() and passes.is_contiguous()):
        raise ValueError("bad_ray_count: every argument must be contiguous")
    return plan


def ray_mark_image(start, end, beam_mask, height: int, width: int):
    """Per-scan mark image (H, W) int32: 1 on each ray's free prefix
    ``t ∈ [0, n-1]``, 2 at endpoints, occupied beats free; out-of-map cells
    are dropped. start (2,) i32 [x, y], end (P,2) i32, beam_mask (P,) bool."""
    if not start.is_cuda:
        from ..raster import mark_image_plain

        return mark_image_plain(start, end, beam_mask, height, width)
    global mark_launches
    plan = _mark_plan(start, end, beam_mask, height, width, MARK_DESIGN)
    mark = start.new_empty(plan.out_shape)
    err = launch.call(_launcher(*_MARK_FN), plan.index, start.data_ptr(), end.data_ptr(),
                      beam_mask.data_ptr(), mark.data_ptr(), plan.geometry_ptr)
    if err != 0:
        raise RuntimeError(
            f"ray_mark_image {plan.count_key}: launch failed (CUDA error {err})")
    mark_launches += 1
    mark_shapes[plan.count_key] += 1
    return mark


def bad_ray_count(start, end, ray_ok, hits, passes, min_passthrough: float,
                  occu_threshold: float, thr_d2: int):
    """(B,) int32 count of rays that visit, for ``t ∈ [0, n]``, an occupied
    cell (``passes >= min_passthrough`` and ``hits/passes >= occu_threshold``)
    with squared cell distance ``>= thr_d2`` from the endpoint.
    start (B,2) i32, end (B,S,2) i32, ray_ok (B,S) bool, hits/passes (H,W)
    f32. Launches on one device go to one stream at a time (the kernel's
    scratch is shared)."""
    if not start.is_cuda:
        from ..raycast import bad_rays_plain

        return bad_rays_plain(start, end, ray_ok, hits, passes,
                              min_passthrough, occu_threshold, thr_d2)
    global check_launches
    plan = _check_plan(start, end, ray_ok, hits, passes, min_passthrough,
                       occu_threshold, thr_d2)
    out = start.new_empty(plan.out_shape)
    err = launch.call(_launcher(*_CHECK_FN), plan.index, start.data_ptr(), end.data_ptr(),
                      ray_ok.data_ptr(), hits.data_ptr(), passes.data_ptr(),
                      out.data_ptr(), plan.tickets_ptr, plan.params_ptr)
    if err != 0:
        raise RuntimeError(
            f"bad_ray_count {plan.count_key}: launch failed (CUDA error {err})")
    check_launches += 1
    check_shapes[plan.count_key] += 1
    return out


def prepared_mark_launch(start, end, beam_mask, mark, design: int = MARK_DESIGN):
    """A function of no arguments that launches the carve into ``mark``
    (H, W) through the bound C function, every argument prepared once: what
    a launch costs without the wrapper's host work. ``design`` is one of
    ``MARK_DESIGNS``. For measurements; it counts no launch."""
    height, width = mark.shape
    plan = _mark_plan(start, end, beam_mask, height, width, design)
    build.check_tensor("mark", mark, torch.int32, plan.out_shape, start.device)
    args = (start.data_ptr(), end.data_ptr(), beam_mask.data_ptr(), mark.data_ptr(),
            plan.geometry_ptr)
    fn, index = _launcher(*_MARK_FN), plan.index

    def bare():
        err = fn(*args, launch.raw_stream(index))
        if err != 0:
            raise RuntimeError(f"ray_mark_image: launch failed (CUDA error {err})")

    return bare


def prepared_check_launch(start, end, ray_ok, hits, passes, min_passthrough: float,
                          occu_threshold: float, thr_d2: int, out, ticket: bool = True):
    """The same for the ray check, into ``out`` (B,). With ``ticket=False``
    the count is zeroed on the stream and the blocks add to it atomically
    (the same counts; what the ticket reduction costs or saves)."""
    plan = _check_plan(start, end, ray_ok, hits, passes, min_passthrough,
                       occu_threshold, thr_d2, ticket)
    build.check_tensor("out", out, torch.int32, plan.out_shape, start.device)
    args = (start.data_ptr(), end.data_ptr(), ray_ok.data_ptr(), hits.data_ptr(),
            passes.data_ptr(), out.data_ptr(), plan.tickets_ptr, plan.params_ptr)
    fn, index = _launcher(*_CHECK_FN), plan.index

    def bare():
        err = fn(*args, launch.raw_stream(index))
        if err != 0:
            raise RuntimeError(f"bad_ray_count: launch failed (CUDA error {err})")

    return bare


# ---- the kernels' index arithmetic in plain PyTorch (int64 tensors) ----

def _fits(x, bits: int):
    """``x``, after checking that a ``bits``-bit integer holds it (the
    kernels' narrow path computes in 32 bits and would wrap)."""
    if bits == 32 and x.numel() and int(x.abs().max()) >= 2 ** 31:
        raise OverflowError("intermediate leaves 32 bits")
    return x


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def needs_wide(start, end):
    """Which rays the kernels walk in 64 bits: start (..., 2), end
    (..., P, 2) -> (..., P) bool. The others have ``n <= NARROW_MAX_N`` and
    coordinates below ``NARROW_MAX_COORD``, so that 2n² + 3n < 2³¹."""
    start = start.to(torch.int64)[..., None, :]
    end = end.to(torch.int64)
    n = (end - start).abs().amax(-1)
    big = (end.abs().amax(-1) >= NARROW_MAX_COORD) | (start.abs().amax(-1) >= NARROW_MAX_COORD)
    return (n > NARROW_MAX_N) | big


def dda_stepped(d, n, t0, stride: int, count: int, bits: int = 64):
    """Cell offsets ``floor((2·d·t + n) / 2n)`` at ``t = t0 + k·stride``,
    ``k < count``, as the kernels step them: one quotient and remainder for
    the first step, one for ``2·d·stride``, then two adds and a carry per
    step. d, n, t0: int64 tensors of one shape; returns (..., count)."""
    m = 2 * n
    first = _fits(2 * d * t0 + n, bits)
    q, r = _floor_div(first, m), first % m
    jump = _fits(2 * d * stride, bits)
    dq, dr = _floor_div(jump, m), jump % m
    out = []
    for _ in range(count):
        out.append(q)
        q, r = q + dq, _fits(r + dr, bits)
        carry = r >= m
        q, r = q + carry.to(torch.int64), torch.where(carry, r - m, r)
    return torch.stack(out, -1)


def tile_plan(height: int, width: int):
    """Tile rows, tile columns, threads of a block, and the grid (tiles down,
    tiles across) of the tile-major carve on a ``height`` x ``width`` image.
    Tile (i, j) holds rows [i·th, (i+1)·th) and columns [j·tw, (j+1)·tw) as
    far as the image goes."""
    th, tw, threads = TILE
    return th, tw, threads, -(-height // th), -(-width // tw)


def _axis_steps(d, n, lo, hi, bits):
    """Steps whose cell offset along one axis lies in [lo, hi]: (some, t_lo,
    t_hi), as ``axis_steps`` of raycarve.cu."""
    zero = torch.zeros_like(d)
    x0 = torch.maximum(lo, torch.minimum(d, zero))
    x1 = torch.minimum(hi, torch.maximum(d, zero))
    some = x0 <= x1
    m = 2 * n
    a = _fits(m * torch.where(some, x0, zero) - n, bits)
    b = _fits(m * torch.where(some, x1, zero) + n - 1, bits)
    neg = d < 0
    a, b = torch.where(neg, -b, a), torch.where(neg, -a, b)
    den = torch.where(d == 0, 1, 2 * d.abs())
    t_lo = _floor_div(_fits(a + den - 1, bits), den)
    t_hi = _floor_div(b, den)
    still = d == 0
    return some, torch.where(still, zero, t_lo), torch.where(still, n, t_hi)


def tile_steps(start, end, x0: int, y0: int, x1: int, y1: int, bits: int = 64):
    """The free steps ``[t_lo, t_hi]`` (within ``[0, n-1]``) of every beam
    whose cells lie in the tile of columns [x0, x1] and rows [y0, y1]; a
    beam with none has ``t_lo > t_hi``. start (2,), end (P, 2)."""
    start, end = start.to(torch.int64), end.to(torch.int64)
    d = end - start[None, :]
    n = d.abs().amax(-1).clamp(min=1)
    sx, sy = start[0], start[1]
    some_x, xl, xh = _axis_steps(d[:, 0], n, (x0 - sx).expand_as(n),
                                 (x1 - sx).expand_as(n), bits)
    some_y, yl, yh = _axis_steps(d[:, 1], n, (y0 - sy).expand_as(n),
                                 (y1 - sy).expand_as(n), bits)
    t_lo = torch.maximum(torch.maximum(xl, yl), torch.zeros_like(n))
    t_hi = torch.minimum(torch.minimum(xh, yh), n - 1)
    none = ~(some_x & some_y)
    return torch.where(none, 1, t_lo), torch.where(none, 0, t_hi)


def mark_image_tiled(start, end, beam_mask, height: int, width: int):
    """The tile-major carve, tile by tile as the kernel does it: a tile holds
    two planes, "free" and "endpoint"; every beam whose start/end box meets
    the tile sets "endpoint" at its endpoint if that lies inside and walks
    from its entry step (``tile_steps``; 0 where the sensor lies inside) with
    ``dda_stepped``, setting "free" until its cell leaves the tile or its
    free prefix ends; a cell is 2 where "endpoint" is set, else 1 where
    "free" is. Rays of ``needs_wide`` compute in 64 bits, the others in 32."""
    th, tw, _, tiles_y, tiles_x = tile_plan(height, width)
    image = torch.empty((height, width), dtype=torch.int32)
    start64, end64 = start.to(torch.int64), end.to(torch.int64)
    wide = needs_wide(start, end)
    d = end64 - start64[None, :]
    n = d.abs().amax(-1).clamp(min=1)
    steps = max(th, tw)         # a run inside moves a cell a step on one axis
    for y0 in range(0, tiles_y * th, th):
        for x0 in range(0, tiles_x * tw, tw):
            x1, y1 = x0 + tw - 1, y0 + th - 1       # past the map's edge too
            free = torch.zeros((th, tw), dtype=torch.bool)
            ends_at = torch.zeros((th, tw), dtype=torch.bool)
            boxed = ((torch.minimum(start64[0], end64[:, 0]) <= x1)
                     & (torch.maximum(start64[0], end64[:, 0]) >= x0)
                     & (torch.minimum(start64[1], end64[:, 1]) <= y1)
                     & (torch.maximum(start64[1], end64[:, 1]) >= y0))
            for bits, rays in ((32, beam_mask & boxed & ~wide), (64, beam_mask & boxed & wide)):
                if not bool(rays.any()):
                    continue
                t_lo, t_hi = tile_steps(start, end[rays], x0, y0, x1, y1, bits)
                dd, nn = d[rays], n[rays]
                lx = start64[0] - x0 + dda_stepped(dd[:, 0], nn, t_lo, 1, steps + 1, bits)
                ly = start64[1] - y0 + dda_stepped(dd[:, 1], nn, t_lo, 1, steps + 1, bits)
                t = t_lo[:, None] + torch.arange(steps + 1)[None, :]
                inside = (lx >= 0) & (lx < tw) & (ly >= 0) & (ly < th) & (t < nn[:, None])
                on = inside.cumprod(-1).bool()             # the walk ends at the first miss
                # the run is the closed form's, and ends inside the steps allowed
                assert torch.equal(on.sum(-1), (t_hi - t_lo + 1).clamp(min=0))
                assert not bool(on[:, -1].any())
                free[ly[on], lx[on]] = True
            ends = end64[beam_mask]
            inside = ((ends[:, 0] >= x0) & (ends[:, 0] <= x1)
                      & (ends[:, 1] >= y0) & (ends[:, 1] <= y1))
            ends_at[ends[inside, 1] - y0, ends[inside, 0] - x0] = True
            both = torch.where(ends_at, 2, free.to(torch.int32)).to(torch.int32)
            image[y0:y0 + th, x0:x0 + tw] = both[:height - y0, :width - x0]
    return image


def mark_image_beams(start, end, beam_mask, height: int, width: int, team: int = 32):
    """The beam-major carve as the kernel does it: the image zeroed, then
    lane l of a beam's ``team`` lanes visits t = l, l + team, ... with the
    stepped DDA and raises the cell to 1 (2 at t = n); of a run of valid
    beams only the first visits t = 0. Rays of ``needs_wide`` compute in 64
    bits, the others in 32."""
    image = torch.zeros((height * width,), dtype=torch.int32)
    start64, end64 = start.to(torch.int64), end.to(torch.int64)
    wide = needs_wide(start, end)
    d = end64 - start64[None, :]
    n = d.abs().amax(-1).clamp(min=1)
    first = beam_mask & ~torch.cat([beam_mask[:1] & False, beam_mask[:-1]])
    lane = torch.arange(team)
    for bits, rays in ((32, beam_mask & ~wide), (64, beam_mask & wide)):
        if not bool(rays.any()):
            continue
        dd, nn = d[rays], n[rays]
        shape = (nn.shape[0], team)
        count = -(-(int(nn.max()) + 1) // team)
        t0, n_l = lane[None, :].expand(shape), nn[:, None].expand(shape)
        cx = start64[0] + dda_stepped(dd[:, 0:1].expand(shape), n_l, t0, team, count, bits)
        cy = start64[1] + dda_stepped(dd[:, 1:2].expand(shape), n_l, t0, team, count, bits)
        t = t0[..., None] + team * torch.arange(count)                 # (R, team, count)
        on = ((t <= nn[:, None, None]) & ((t > 0) | first[rays][:, None, None])
              & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height))
        value = torch.where(t == nn[:, None, None], 2, 1).to(torch.int32)
        image.scatter_reduce_(0, (cy * width + cx)[on], value[on], "amax")
    return image.reshape(height, width)


@dataclasses.dataclass(frozen=True)
class CheckGeometry:
    """Launch geometry of the ray check for B poses of S rays: a block of
    ``threads`` threads takes ``CHECK_WARPS`` rays of one pose, a warp each;
    ``groups`` blocks per pose, grid (groups, B); the scratch holds a 64-bit
    word per pose, to which a block adds ``pack(its count)`` with one
    atomic: arrivals in the high half, bad rays in the low half."""

    groups: int
    grid: tuple
    threads: int
    tickets: int

    @staticmethod
    def pack(count: int) -> int:
        return (1 << 32) | count

    def last(self, seen: int) -> bool:
        """Whether the block whose atomic returned ``seen`` stores the
        pose's count (``(seen + its own) mod 2³²``) and zeroes the word."""
        return seen >> 32 == self.groups - 1

    def rays_of(self, group: int, S: int) -> range:
        return range(group * CHECK_WARPS, min((group + 1) * CHECK_WARPS, S))


def check_geometry(B: int, S: int) -> CheckGeometry:
    if B > MAX_GRID_Y:
        raise ValueError(f"bad_ray_count: {B} poses, at most {MAX_GRID_Y}")
    groups = max(1, -(-S // CHECK_WARPS))
    return CheckGeometry(groups, (groups, B), 32 * CHECK_WARPS, B)


def bad_rays_stepped(start, end, ray_ok, hits, passes, min_passthrough: float,
                     occu_threshold: float, thr_d2: int):
    """The check kernel's walk in plain PyTorch, same arguments as
    ``bad_ray_count``: lane l of a ray's warp visits t = l, l + 32, ... with
    the stepped DDA, in rounds of ``CHECK_ROUNDS`` steps; the integer
    distance test comes first, the planes are read only where it passes; a
    block adds its rays' count to the pose's word, and the block that finds
    every other arrival there stores the sum."""
    H, W = hits.shape
    B, S = ray_ok.shape
    start64, end64 = start.to(torch.int64), end.to(torch.int64)
    d = end64 - start64[:, None, :]                                # (B,S,2)
    n = d.abs().amax(-1).clamp(min=1)
    live = torch.where(ray_ok, n, 0)
    rounds = -(-(int(live.max()) + 1 if live.numel() else 1) // (32 * CHECK_ROUNDS))
    count = rounds * CHECK_ROUNDS
    lane = torch.arange(32)
    wide = needs_wide(start, end)
    bad = torch.zeros((B, S), dtype=torch.bool)
    for bits, rays in ((32, ray_ok & ~wide), (64, ray_ok & wide)):
        if not bool(rays.any()):
            continue
        dd, nn = d[rays], n[rays]                                  # (R,2), (R,)
        shape = (nn.shape[0], 32)
        t0 = lane[None, :].expand(shape)
        n_l = nn[:, None].expand(shape)
        cx = start64[:, None, 0].expand(B, S)[rays][:, None, None] + dda_stepped(
            dd[:, 0:1].expand(shape), n_l, t0, 32, count, bits)    # (R,32,count)
        cy = start64[:, None, 1].expand(B, S)[rays][:, None, None] + dda_stepped(
            dd[:, 1:2].expand(shape), n_l, t0, 32, count, bits)
        t = t0[..., None] + 32 * torch.arange(count)
        ex, ey = end64[rays][:, 0, None, None], end64[rays][:, 1, None, None]
        look = (t <= nn[:, None, None]) & ((cx - ex) ** 2 + (cy - ey) ** 2 >= thr_d2)
        p = passes[cy.clamp(0, H - 1), cx.clamp(0, W - 1)]
        h = hits[cy.clamp(0, H - 1), cx.clamp(0, W - 1)]
        prob = torch.where(p > 0, h / torch.clamp(p, min=1e-9), 0.5)
        occupied = (p >= min_passthrough) & (prob >= occu_threshold)
        bad[rays] = (look & occupied).flatten(1).any(-1)
    g = check_geometry(B, S)
    out = torch.full((B,), -1, dtype=torch.int32)
    for b in range(B):
        word = 0
        for group in reversed(range(g.groups)):       # any order of arrival
            rays_ = g.rays_of(group, S)
            count = int(bad[b, rays_.start:rays_.stop].sum())
            seen, word = word, word + g.pack(count)
            if g.last(seen):
                out[b] = ((seen + count) & 0xFFFFFFFF)
    return out
