"""Wrappers of the two correlation scoring CUDA kernels.

``correlation_scores`` (``correlation.cu``) and ``correlation_scores_v2``
(``correlation_v2.cu``) compute the same function with the same arguments.
Both cut the sample axis into the same slices and add the slices' partial
sums in slice order, so they agree bit for bit; the first reads one map cell
per (candidate, sample), the second lets the candidates of a window share
the loads of the box of cells they cover. ``kernel_version()`` says which
one the matcher uses: the environment variable ``ROBORTS_CORR_KERNEL``
(default 1), as in the JAX package. Each wrapper launches its kernel for
tensors on the card and takes the plain PyTorch version
(``ops.correlative.correlation_scores_plain``, the one plain version beside
both kernels) only for CPU tensors. There is no fallback: on a CUDA tensor it
launches the kernel or raises.

The launch geometry of both kernels (slices, candidate groups, threads,
shared bytes, the second kernel's box buffers) is computed here, by
``launch_geometry``, and passed to the launchers.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import os

import torch

from . import build, launch

launches = 0      # launches of the first kernel (counted only where it launches)
launches_v2 = 0   # launches of the second kernel
# the same launches by shape: (kernel version, B, A, S, N, H, W) -> count
launch_shapes: collections.Counter = collections.Counter()
# all three are counted by ``_count``, under ``launch.count_lock``

_V2_ENV = "ROBORTS_CORR_KERNEL"
MAX_SHARED_BYTES = 232_448    # shared memory a block may opt in to (227 KB)
SLICE_MIN = 8                 # samples per slice, unless that gives over MAX_SLICES
MAX_SLICES = 128
BLOCK_THREADS = 256           # most threads of the first kernel's blocks (kBlockThreads of correlation.cu)
V2_SUB = 8                    # kSub of correlation_v2.cu: samples a team keeps in flight
V2_SLOTS = (1, 2, 4)          # kSlots of correlation_v2.cu: candidates a lane may own
V2_BLOCK_THREADS = 512        # most threads of the second kernel's blocks (kBlockThreads of correlation_v2.cu)

_SOURCES = {1: ("correlation", "correlation_scores_launch"),
            2: ("correlation_v2", "correlation_scores_v2_launch")}
_fns: dict[int, object] = {}
_plans: dict[tuple, "_Plan"] = {}


def kernel_version() -> int:
    """Which scoring kernel the matcher uses: ``ROBORTS_CORR_KERNEL`` as an
    integer, 1 when unset or not a number."""
    try:
        return int(os.environ.get(_V2_ENV, "1"))
    except ValueError:
        return 1


def scores_fn():
    """The ``correlation_scores``-shaped wrapper ``kernel_version()`` selects."""
    return correlation_scores_v2 if kernel_version() == 2 else correlation_scores


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of both kernels for one shape.

    Shared by both (it fixes the order of the sums): ``slice_len`` samples
    per slice, ``slices`` = ceil(S / slice_len). First kernel: the N*N
    candidates of a (map, angle) are cut into ``groups`` blocks of
    ``group_size`` candidates; a block is ``group_size`` x ``slices``
    threads. Second kernel: the window's rows (ky) are cut into
    ``v2_groups`` blocks of ``v2_rows`` rows; in a block, ``v2_teams`` teams
    of ``v2_team`` lanes take a slice each, a lane owning up to ``v2_slots``
    candidates; a sample's box of cells is copied whole where it has no more
    cells than the block has candidates."""

    slice_len: int
    slices: int
    groups: int
    group_size: int
    threads: int
    shared_bytes: int
    v2_groups: int
    v2_rows: int
    v2_team: int
    v2_slots: int
    v2_teams: int
    v2_threads: int
    v2_shared_bytes: int

    def slice_bounds(self, S: int) -> list[tuple[int, int]]:
        """[s0, s1) of every slice, in the order their sums are added."""
        return [(p * self.slice_len, min(S, (p + 1) * self.slice_len))
                for p in range(self.slices)]


def launch_geometry(A: int, S: int, N: int, H: int, W: int) -> Geometry:
    """Geometry of both kernels for A angles, S samples, an N x N window and
    an H x W map. Raises ``ValueError`` for a shape the kernels do not take."""
    if min(A, S, N, H, W) < 1:
        raise ValueError(f"correlation kernels: empty axis in A={A}, S={S}, "
                         f"N={N}, H={H}, W={W}")
    C = N * N
    L = max(SLICE_MIN, -(-S // MAX_SLICES))
    P = -(-S // L)

    # first kernel: a thread per (candidate, slice), in blocks of at most
    # BLOCK_THREADS threads (P <= MAX_SLICES < BLOCK_THREADS)
    groups = -(-C // min(C, BLOCK_THREADS // P))
    group_size = -(-C // groups)
    shared = 4 * (2 * S + P * group_size) + S

    # second kernel: a team per slice in a block of at most V2_BLOCK_THREADS
    # threads; a team as wide as that allows (a power of two of lanes), a
    # group of as many window rows as give each lane about one candidate
    widest = 1
    while widest < 32 and 2 * widest * P <= V2_BLOCK_THREADS:
        widest *= 2
    # the rows per group, slots per lane and lanes per team that leave the
    # fewest lanes without a candidate (then the fewest slots, the fewest rows)
    best = (0.0, 0, 0, 1, widest, V2_SLOTS[-1])     # a group larger than a pass
    for slots in V2_SLOTS:
        for rows in range(1, N + 1):
            team = 1
            while team * slots < rows * N:
                team *= 2
            if team > widest:
                break
            busy = N * N / (-(-N // rows) * team * slots)
            best = max(best, (busy, -slots, -rows, rows, team, slots))
    rows, team, slots = best[3:]
    v2_groups = -(-N // rows)
    chunk = slots * team
    fixed = 4 * (2 * S + P * chunk) + S
    per_team = 4 * V2_SUB * chunk
    # whole warps of teams: as many as there are slices, or as fit
    per_warp = 32 // team
    teams = per_warp * min(-(-P // per_warp), V2_BLOCK_THREADS // 32,
                           (MAX_SHARED_BYTES - fixed) // (per_team * per_warp))
    if shared > MAX_SHARED_BYTES or teams < 1:
        raise ValueError(f"correlation kernels: S={S}, N={N} need more shared "
                         f"memory than a block has ({MAX_SHARED_BYTES} bytes)")
    return Geometry(L, P, groups, group_size, group_size * P, shared,
                    v2_groups, rows, team, slots, teams, team * teams,
                    fixed + teams * per_team)


def _launcher(version: int):
    fn = _fns.get(version)
    if fn is None:
        source, symbol = _SOURCES[version]
        fn = getattr(build.load(source), symbol)
        # eight tensors, the geometry array, default_prob, the stream
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[version] = fn
    return fn


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a launch at one validated combination of shapes, dtypes and
    devices needs, computed once."""

    fn: object                # the bound launcher
    geometry: object          # ctypes int array: B, A, S, N, H, W, then the geometry
    geometry_ptr: int         # its address
    out_shape: tuple          # (B, A, N, N)
    index: int                # the device's index
    count_key: tuple          # key into ``launch_shapes``


def _new_plan(key, version, tensors) -> _Plan:
    """Validate one combination of shapes, dtypes and devices, and compute
    what its launches need."""
    probs, rx, _, _, xs, _, _ = tensors
    _check_dims(probs, rx, xs)
    B, H, W = probs.shape
    _, A, S = rx.shape
    N = xs.shape[1]
    dev = probs.device
    f32 = torch.float32
    wanted = (("probs", f32, (B, H, W)), ("rx", f32, (B, A, S)),
              ("ry", f32, (B, A, S)), ("svalid", torch.bool, (B, S)),
              ("xs", f32, (B, N)), ("ys", f32, (B, N)), ("divisor", f32, (B,)))
    for t, (name, dtype, shape) in zip(tensors, wanted):
        build.check_tensor(name, t, dtype, shape, dev)
    g = launch_geometry(A, S, N, H, W)
    if version == 2:
        ints = (B, A, S, N, H, W, g.slice_len, g.slices, g.v2_groups, g.v2_rows,
                g.v2_team, g.v2_slots, g.v2_teams, g.v2_shared_bytes, 1)
    else:
        ints = (B, A, S, N, H, W, g.slice_len, g.slices, g.groups, g.group_size,
                g.shared_bytes)
    geometry = (ctypes.c_int * len(ints))(*ints)
    plan = _Plan(_launcher(version), geometry, ctypes.addressof(geometry),
                 (B, A, N, N), dev.index, (version, B, A, S, N, H, W))
    if len(_plans) >= 1024:         # an engine sees a few dozen combinations
        _plans.clear()
    _plans[key] = plan
    return plan


def _plan(version, probs, rx, ry, svalid, xs, ys, divisor) -> _Plan:
    """The plan for these tensors, looked up by their shapes, dtypes and
    devices (validated at the first sight of a combination); raises unless
    every tensor is contiguous."""
    key = (version,
           probs.shape, rx.shape, ry.shape, svalid.shape, xs.shape, ys.shape,
           divisor.shape,
           probs.dtype, rx.dtype, ry.dtype, svalid.dtype, xs.dtype, ys.dtype,
           divisor.dtype,
           probs.device, rx.device, ry.device, svalid.device, xs.device, ys.device,
           divisor.device)
    plan = _plans.get(key)
    if plan is None:
        plan = _new_plan(key, version, (probs, rx, ry, svalid, xs, ys, divisor))
    if not (probs.is_contiguous() and rx.is_contiguous() and ry.is_contiguous()
            and svalid.is_contiguous() and xs.is_contiguous()
            and ys.is_contiguous() and divisor.is_contiguous()):
        raise ValueError("correlation_scores: every argument must be contiguous")
    return plan


def _count(version: int, key: tuple):
    """Count one launch of kernel ``version`` at shape ``key``."""
    global launches, launches_v2
    with launch.count_lock:
        if version == 2:
            launches_v2 += 1
        else:
            launches += 1
        launch_shapes[key] += 1


def _run(version, probs, rx, ry, svalid, xs, ys, default_prob, divisor):
    """Launch kernel ``version`` on the current stream of the tensors' device
    and count the launch by shape; raises if the launch is refused."""
    plan = _plan(version, probs, rx, ry, svalid, xs, ys, divisor)
    scores = rx.new_empty(plan.out_shape)
    args = (probs.data_ptr(), rx.data_ptr(), ry.data_ptr(), svalid.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), divisor.data_ptr(), scores.data_ptr(),
            plan.geometry_ptr, default_prob)
    err = launch.call(plan.fn, plan.index, *args)
    if err != 0:
        raise RuntimeError(
            f"correlation kernel {plan.count_key}: launch failed (CUDA error {err})")
    launch.counted(_count, version, plan.count_key)
    return scores


def _check_dims(probs, rx, xs):
    if probs.dim() != 3 or rx.dim() != 3 or xs.dim() != 2:
        raise ValueError("correlation_scores: probs (B,H,W), rx (B,A,S), xs (B,N)")


def _plain(probs, rx, ry, svalid, xs, ys, default_prob, divisor):
    from ..correlative import correlation_scores_plain

    _check_dims(probs, rx, xs)
    return correlation_scores_plain(probs, rx, ry, svalid, xs, ys, default_prob,
                                    divisor)


def correlation_scores(probs, rx, ry, svalid, xs, ys, default_prob: float,
                       divisor):
    """scores (B,A,N,N) f32, indexed [a, kx, ky]:
    ``(Σ_s probs[b, gy, gx]) / divisor[b]`` with
    ``gx = floor(rx[b,a,s] + xs[b,kx] + 0.5)``, ``gy`` likewise; invalid
    samples add exact 0, out-of-map cells add ``default_prob``.

    probs (B,H,W) f32, rx/ry (B,A,S) f32, svalid (B,S) bool, xs/ys (B,N)
    f32, divisor (B,) f32 — all contiguous and on one device."""
    if not probs.is_cuda:
        return _plain(probs, rx, ry, svalid, xs, ys, default_prob, divisor)
    return _run(1, probs, rx, ry, svalid, xs, ys, default_prob, divisor)


def correlation_scores_v2(probs, rx, ry, svalid, xs, ys, default_prob: float,
                          divisor):
    """The same function and arguments as ``correlation_scores``, computed
    by the second kernel (``correlation_v2.cu``): where the N*N candidate
    cells of a sample fill a box of no more cells than the window has
    candidates, the box is loaded once and every candidate takes its cell
    from it."""
    if not probs.is_cuda:
        return _plain(probs, rx, ry, svalid, xs, ys, default_prob, divisor)
    return _run(2, probs, rx, ry, svalid, xs, ys, default_prob, divisor)


def prepared_launch(version: int, probs, rx, ry, svalid, xs, ys,
                    default_prob: float, divisor, scores, stage_boxes: bool = True):
    """A function of no arguments that launches kernel ``version`` on these
    tensors into ``scores`` through the bound C function, with every argument
    prepared once: what a launch costs without the wrapper's host work. With
    ``stage_boxes=False`` the second kernel stages no box and every candidate
    reads its own cell (the same sums; what the staging costs or saves). For
    measurements; it counts no launch."""
    plan = _plan(version, probs, rx, ry, svalid, xs, ys, divisor)
    build.check_tensor("scores", scores, torch.float32, plan.out_shape, probs.device)
    geometry = type(plan.geometry)(*plan.geometry)     # a copy this launch owns
    if version == 2:
        geometry[len(geometry) - 1] = int(stage_boxes)
    args = (probs.data_ptr(), rx.data_ptr(), ry.data_ptr(), svalid.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), divisor.data_ptr(), scores.data_ptr(),
            ctypes.addressof(geometry), float(default_prob))
    fn, index = plan.fn, plan.index

    def bare(_keep=geometry):
        err = fn(*args, launch.raw_stream(index))
        if err != 0:
            raise RuntimeError(f"correlation kernel: launch failed (CUDA error {err})")

    return bare


def box_layout(rx, ry, xs, ys, H: int, W: int, limit: int):
    """Plain PyTorch statement of the second kernel's box indexing, for
    rx/ry (B,A,S), xs (B,N) and the ys (B,R) of one group of window rows on
    an H x W map.

    Per sample: the box ``x_lo``, ``y_lo``, ``width``, ``height`` (B,A,S) —
    columns gx(0)..gx(N-1) by rows gy(0)..gy(R-1), clipped to the map, empty
    (height 0) where nothing of it is in the map — and ``boxed`` (B,A,S):
    whether the kernel copies the box (it has at most ``limit`` cells: the
    group's candidates, R * N) or each candidate's own cell. Per candidate,
    indexed [kx, ky]: ``inside`` (B,A,S,N,R), whether its cell is in the map;
    ``in_box``, whether it is in the box (always, if inside, for ascending
    xs and ys; the kernel reads any other cell where it lies); ``pos``, its
    entry in the box, row-major over the box (0 where not in the box)."""
    fx = torch.floor(rx[..., None] + xs[:, None, None, :] + 0.5)    # (B,A,S,N)
    fy = torch.floor(ry[..., None] + ys[:, None, None, :] + 0.5)    # (B,A,S,R)
    # clipped as floats, as the kernel does before its casts
    bx0, bx1 = fx[..., 0].clamp(min=0), fx[..., -1].clamp(max=W - 1)
    by0, by1 = fy[..., 0].clamp(min=0), fy[..., -1].clamp(max=H - 1)
    some = (bx0 <= bx1) & (by0 <= by1)
    zero = torch.zeros_like(bx0)
    x_lo = torch.where(some, bx0, zero).to(torch.int64)
    y_lo = torch.where(some, by0, zero).to(torch.int64)
    width = torch.where(some, bx1 - bx0 + 1, zero + 1).to(torch.int64)
    height = torch.where(some, by1 - by0 + 1, zero).to(torch.int64)
    col = torch.where((fx >= 0) & (fx < W), fx, -1.0).to(torch.int64)[..., :, None]
    row = torch.where((fy >= 0) & (fy < H), fy, -1.0).to(torch.int64)[..., None, :]
    inside = (col >= 0) & (row >= 0)
    xl, yl = x_lo[..., None, None], y_lo[..., None, None]
    wd, ht = width[..., None, None], height[..., None, None]
    in_box = inside & (col >= xl) & (col < xl + wd) & (row >= yl) & (row < yl + ht)
    pos = torch.where(in_box, (row - yl) * wd + col - xl, 0)
    return {"x_lo": x_lo, "y_lo": y_lo, "width": width, "height": height,
            "boxed": width * height <= limit, "inside": inside, "in_box": in_box,
            "pos": pos}
