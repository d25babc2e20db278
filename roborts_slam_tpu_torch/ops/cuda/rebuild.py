"""Wrapper of the correction rebuild's count kernel (K7,
``rebuild_counts_launch`` of ``raycarve.cu``).

``rebuild_counts`` writes the pub map's hit and pass planes of a batch of
stored scans — every slot's mark image (1 free, 2 endpoint; one mark a cell
a scan) added as ``_add_marks`` adds it, and scan 0's ``extra`` more times —
in one call of the C function: a memset, the count tables, and a walk and a
count a chunk of slots. On the card it launches the kernels and raises on
anything else; for CPU tensors it takes the plain version,
``ops.raster.rebuild_counts_plain`` (the loop of one carve and one plane
update a slot, JAX's ``lax.scan``). There is no fallback.

Every increment a cell gets is the same float32 constant, so the kernel
counts marks in integers and turns a count into the float32 sum that as many
sequential adds give (``count_table``): equal to the loop bit for bit. What
the kernel's index arithmetic rests on is stated here in plain PyTorch for
the CPU tests: the chunks, words and bits (``geometry``, ``Geometry.place``)
and the chunked count (``rebuild_counts_stepped``).

A launch is one wrapper call (all of its kernels), counted by shape (slots,
beams, H, W) in ``rebuild_shapes``, through ``launch.counted``: a call
captured into a CUDA graph is counted at each replay.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from . import build, launch

rebuild_launches = 0     # rebuild_counts calls on the card so far
rebuild_shapes: collections.Counter = collections.Counter()   # (B, P, H, W) -> calls

SCRATCH_BYTES = 64 << 20  # the bit planes of one chunk at most
MAX_WORDS = 2047          # words a cell a chunk: a chunk's places (the grid's y) < 65536

_fns: dict[str, object] = {}
_plans: dict[tuple, "_Plan"] = {}


class _Params(ctypes.Structure):
    """``RebuildParams`` of raycarve.cu."""

    _fields_ = [("B", ctypes.c_int), ("P", ctypes.c_int), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("extra", ctypes.c_int), ("slots", ctypes.c_int),
                ("chunks", ctypes.c_int), ("words", ctypes.c_int),
                ("per_chunk", ctypes.c_int), ("table", ctypes.c_int),
                ("occu_inc", ctypes.c_float), ("free_inc", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one call spreads ``B`` slots of ``P`` beams over an ``H`` x ``W``
    map: ``slots`` virtual slots (the B stored ones, then scan 0's extra
    slot where ``extra`` > 0) in ``chunks`` chunks; virtual slot v lies in
    chunk ``v % chunks`` at place ``v // chunks`` (at most ``per_chunk``
    places), in word ``place % words`` and bit ``place // words`` of the
    cell's words; ``table`` entries in each count table; ``scratch_words``
    32-bit words of scratch (the bits of one chunk, the counts where there
    are two chunks or more, the two tables)."""

    B: int
    P: int
    H: int
    W: int
    extra: int
    slots: int
    chunks: int
    words: int
    per_chunk: int
    table: int
    scratch_words: int

    def place(self, v: int) -> tuple[int, int, int]:
        """(chunk, word, bit) of virtual slot ``v``."""
        i = v // self.chunks
        return v % self.chunks, i % self.words, i // self.words


def geometry(B: int, P: int, H: int, W: int, extra: int) -> Geometry:
    """The geometry of a call: as few chunks as keep a chunk's two bit
    planes within ``SCRATCH_BYTES`` (and ``MAX_WORDS``), the slots dealt
    round them, and the fewest words that hold the fullest chunk."""
    if min(B, P, H, W, extra) < 0:
        raise ValueError(f"rebuild_counts: B={B}, P={P}, {H} x {W}, extra={extra}")
    cells = H * W
    slots = B + (extra > 0)
    most = max(1, min(MAX_WORDS, SCRATCH_BYTES // (8 * max(cells, 1))))
    chunks = max(1, -(-slots // (32 * most)))
    per_chunk = max(1, -(-slots // chunks))
    words = -(-per_chunk // 32)
    table = B + extra + 1
    scratch = 2 * words * cells + (2 * cells if chunks > 1 else 0) + 2 * table
    return Geometry(B, P, H, W, extra, slots, chunks, words, per_chunk, table, scratch)


def count_table(inc: float, length: int) -> torch.Tensor:
    """``t[0] = 0``, ``t[k] = t[k-1] + inc`` in float32 (``inc`` rounded to
    float32 first): what ``k`` sequential adds of the increment give, as the
    kernel's tables hold it. Not ``k * inc``, nor a cumulative sum in
    another order: those differ in the last bits."""
    step = np.float32(inc)
    out = np.zeros(length, np.float32)
    for k in range(1, length):
        out[k] = out[k - 1] + step
    return torch.from_numpy(out)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What calls at one validated combination of shapes and increments
    need, made once."""

    geometry: Geometry
    params: object            # a _Params
    params_ptr: int
    index: int                # the device's index


def _launcher():
    """The bound C function (the library is built at the first call)."""
    fn = _fns.get("rebuild")
    if fn is None:
        fn = build.load("raycarve").rebuild_counts_launch
        fn.argtypes = [ctypes.c_void_p] * 12        # the stream included
        fn.restype = ctypes.c_int
        _fns["rebuild"] = fn
    return fn


def _plan(B, P, H, W, extra, free_inc, occu_inc, device) -> _Plan:
    key = (B, P, H, W, extra, free_inc, occu_inc, device)
    plan = _plans.get(key)
    if plan is None:
        geo = geometry(B, P, H, W, extra)
        params = _Params(B, P, H, W, extra, geo.slots, geo.chunks, geo.words,
                         geo.per_chunk, geo.table, occu_inc, free_inc)
        if len(_plans) >= 256:
            _plans.clear()
        plan = _plans[key] = _Plan(geo, params, ctypes.addressof(params), device.index)
    return plan


def _count(shape: tuple):
    """Count one call at ``shape`` (B, P, H, W), under ``launch.count_lock``."""
    global rebuild_launches
    with launch.count_lock:
        rebuild_launches += 1
        rebuild_shapes[shape] += 1


def _checked(start, end, beam_mask, slot_valid, hits, passes, extra, first):
    """The shapes (B, P, H, W), after checking every argument as the kernel
    takes it."""
    if end.dim() != 3 or hits.dim() != 2:
        raise ValueError("rebuild_counts: start (B,2), end (B,P,2), beam_mask (B,P), "
                         "slot_valid (B,), hits and passes (H,W)")
    B, P = end.shape[:2]
    H, W = hits.shape
    dev = start.device
    for name, t, dtype, shape in (
            ("start", start, torch.int32, (B, 2)), ("end", end, torch.int32, (B, P, 2)),
            ("beam_mask", beam_mask, torch.bool, (B, P)),
            ("slot_valid", slot_valid, torch.bool, (B,)),
            ("hits", hits, torch.float32, (H, W)), ("passes", passes, torch.float32, (H, W))):
        build.check_tensor(name, t, dtype, shape, dev)
    if extra < 0:
        raise ValueError(f"rebuild_counts: extra={extra}")
    if extra > 0:
        if B < 1 or first is None or len(first) != 3:
            raise ValueError("rebuild_counts: extra > 0 needs scan 0 and its cells "
                             "(start (2,), end (P,2), beam_mask (P,))")
        for name, t, dtype, shape in (("first start", first[0], torch.int32, (2,)),
                                      ("first end", first[1], torch.int32, (P, 2)),
                                      ("first beam_mask", first[2], torch.bool, (P,))):
            build.check_tensor(name, t, dtype, shape, dev)
    return B, P, H, W


def rebuild_counts(start, end, beam_mask, slot_valid, hits, passes, free_factor,
                   occu_factor, extra: int = 0, first=None):
    """Write the pub map's counts of a batch of scans into ``hits`` and
    ``passes`` (H, W) float32, every cell: slot b's beams ``beam_mask[b]``
    from sensor cell ``start[b]`` (B, 2) int32 to end cells ``end[b]``
    (B, P, 2) int32, where ``slot_valid[b]`` (B,) bool; then ``extra``
    more times the beams of ``first`` = (start (2,), end (P, 2), beam_mask
    (P,)), scan 0's cells as the extra updates compute them. An endpoint
    adds ``1 + occu_factor`` to hits and a visited cell ``1 + free_factor``
    to passes, once a scan. On the card one call, no synchronisation and
    no host read (it captures into a CUDA graph); CPU tensors take the
    plain loop."""
    extra = int(extra)
    B, P, H, W = _checked(start, end, beam_mask, slot_valid, hits, passes, extra, first)
    if not start.is_cuda:
        from ..raster import rebuild_counts_plain

        return rebuild_counts_plain(start, end, beam_mask, slot_valid, hits, passes,
                                    free_factor, occu_factor, extra, first)
    dev = start.device
    plan = _plan(B, P, H, W, extra, float(1.0 + free_factor), float(1.0 + occu_factor), dev)
    scratch = torch.empty((plan.geometry.scratch_words,), dtype=torch.int32, device=dev)
    s0, e0, m0 = first if extra > 0 else (start, end, beam_mask)
    err = launch.call(_launcher(), plan.index, start.data_ptr(), end.data_ptr(),
                      beam_mask.data_ptr(), slot_valid.data_ptr(), s0.data_ptr(),
                      e0.data_ptr(), m0.data_ptr(), hits.data_ptr(), passes.data_ptr(),
                      scratch.data_ptr(), plan.params_ptr)
    if err != 0:
        raise RuntimeError(f"rebuild_counts {plan.geometry}: launch failed (CUDA error {err})")
    launch.counted(_count, (B, P, H, W))
    return hits, passes


def rebuild_counts_stepped(start, end, beam_mask, slot_valid, hits, passes, free_factor,
                           occu_factor, extra: int = 0, first=None):
    """The kernel's algorithm in plain PyTorch, same arguments as
    ``rebuild_counts``: each virtual slot's mark image (the carve's plain
    version) set as its bit in the (chunk, word) that ``Geometry.place``
    gives; per chunk the popcounts of a cell's words added to its integer
    counts (the extra slot's bit ``extra`` times); the counts turned into
    float32 through ``count_table``."""
    from ..raster import mark_image_plain

    B, P, H, W = _checked(start, end, beam_mask, slot_valid, hits, passes, extra, first)
    geo = geometry(B, P, H, W, extra)
    n_pass = torch.zeros((H, W), dtype=torch.int64)
    n_hit = torch.zeros((H, W), dtype=torch.int64)
    for k in range(geo.chunks):
        bits = torch.zeros((2, geo.words, H, W), dtype=torch.int64)
        for v in range(k, geo.slots, geo.chunks):
            _, j, b = geo.place(v)
            if v == B:
                mark = mark_image_plain(*first, H, W)
            else:
                mark = mark_image_plain(start[v], end[v], beam_mask[v] & slot_valid[v], H, W)
            bits[0, j] |= (mark > 0).to(torch.int64) << b
            bits[1, j] |= (mark == 2).to(torch.int64) << b
        ones = [((bits >> b) & 1) for b in range(32)]
        n_pass += sum(o[0] for o in ones).sum(0)
        n_hit += sum(o[1] for o in ones).sum(0)
        if extra > 0 and geo.place(B)[0] == k:
            _, j, b = geo.place(B)
            n_pass += (extra - 1) * ((bits[0, j] >> b) & 1)
            n_hit += (extra - 1) * ((bits[1, j] >> b) & 1)
    hits.copy_(count_table(1.0 + occu_factor, geo.table)[n_hit])
    passes.copy_(count_table(1.0 + free_factor, geo.table)[n_pass])
    return hits, passes


def prepared_rebuild_launch(start, end, beam_mask, slot_valid, hits, passes, free_factor,
                            occu_factor, extra: int = 0, first=None):
    """A function of no arguments that runs the kernel's call into ``hits``
    and ``passes`` through the bound C function, every argument and the
    scratch prepared once: what a call costs without the wrapper's host
    work. For measurements; it counts no launch."""
    B, P, H, W = _checked(start, end, beam_mask, slot_valid, hits, passes, extra, first)
    dev = start.device
    plan = _plan(B, P, H, W, extra, float(1.0 + free_factor), float(1.0 + occu_factor), dev)
    scratch = torch.empty((plan.geometry.scratch_words,), dtype=torch.int32, device=dev)
    s0, e0, m0 = first if extra > 0 else (start, end, beam_mask)
    args = (start.data_ptr(), end.data_ptr(), beam_mask.data_ptr(), slot_valid.data_ptr(),
            s0.data_ptr(), e0.data_ptr(), m0.data_ptr(), hits.data_ptr(), passes.data_ptr(),
            scratch.data_ptr(), plan.params_ptr)
    fn, index = _launcher(), plan.index

    def bare():
        err = fn(*args, launch.raw_stream(index))
        if err != 0:
            raise RuntimeError(f"rebuild_counts: launch failed (CUDA error {err})")

    bare.scratch = scratch        # kept alive with the function
    return bare


def ptxas_report() -> list[str]:
    """What ptxas says of every kernel of ``raycarve.cu`` (registers,
    spills): the rebuild's ``rebuild_*`` beside the carve's and the
    check's. Needs ``nvcc``."""
    return build.ptxas_report("raycarve")
