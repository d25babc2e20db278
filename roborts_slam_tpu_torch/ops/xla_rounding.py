"""Roundings of the JAX package's compiled step, mirrored.

The JAX engine runs its front-end step under ``jax.jit``; inside it XLA on
the CPU rounds four expressions otherwise than their source reads (and
than JAX run op by op, which the plain PyTorch expressions equal):

- ``xy / inv_res - offset`` (``map_to_world_pose``): the division by a
  constant becomes a multiplication by its f32 reciprocal, contracted with
  the subtraction into one fused multiply-add (``map_to_world_xy``);
- ``start + arange(A) * step`` (the search angles): one fused multiply-add
  (``angle_ramp``);
- a tier's candidate offsets ``(xy + offset) * inv_res - half + arange(N)
  * step``: the centre is mapped inside the scoring fusion, its product and
  the subtraction one fused multiply-add, each offset one more
  (``candidate_offsets``);
- the tie average's sums ``sum(w * v)`` over an (A, Nx, Ny) grid: XLA's tree
  reduction splits every reduced dimension longer than 32 into windows of
  32 (the padding split evenly before and after), sums each window in flat
  order with the products rounded first, then sums the windows' partials
  in order; where no reduced dimension is longer than 32 the multiply is
  fused into one sequential sum, one fused multiply-add per term
  (``tie_sums``).

Each helper takes and returns f32 tensors on any device and gives the same
bits on the CPU and on the card: ``fma_f32`` forms the product exactly in
float64 and rounds the float64 sum to f32 (never a contraction the compiler
may or may not make), and the sums are sequential folds of elementwise
operations. The plain path and the kernel path both call them. Inside a
step captured into a CUDA graph they launch only device work: the
reciprocals are host constants of the specs, and ``tie_sums``' tables are
made at a step's first, eager call (a capture that would make one raises).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.launch import capturing_now

# tie terms folded in XLA's order (more: the plain sums). On leg 3's and leg
# 4's logs at full width six cover 99 % of the tiers' tie sets (most hold 1-3)
TIE_SLOTS = 6
XLA_REDUCE_WINDOW = 32     # XLA's CPU tree-reduction window
_TABLES: dict = {}


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` as an f32 fused multiply-add rounds it, from float64:
    the product of two f32 is exact in float64 and the sum is rounded once
    to float64, then to f32. That differs from one rounding only where the
    float64 sum is inexact and lands exactly halfway between two f32 (none
    in the tests' 10^4 inputs a helper; ``tests/test_torch_xla_rounding.py``
    builds such a case); the exact form (the sum rounded to odd) costs a
    dozen more operations a call, each a launch on the card. ``a``, ``b``,
    ``c``: f32 tensors, broadcast together."""
    return (a.double() * b.double() + c.double()).float()


def reciprocal_f32(x: float) -> float:
    """The f32 reciprocal XLA folds a division by the constant ``x`` into
    (``x`` first rounded to f32, as a weakly typed Python float is)."""
    return float(np.float32(1.0) / np.float32(x))


def map_to_world_xy(offset, inv_res: float, xy) -> torch.Tensor:
    """``xy / inv_res - offset`` as XLA compiles it: one fused multiply-add
    by the f32 reciprocal of ``inv_res`` (JAX ``models/grid_map.py``'s
    ``map_to_world_pose`` inside ``jax.jit``), in ``fma_f32``'s form."""
    return (xy.double() * reciprocal_f32(inv_res) - offset.double()).float()


def angle_ramp(start, n: int, step: float) -> torch.Tensor:
    """``start + arange(n) * step`` (start (..., 1)) as XLA compiles it inside
    the step: one fused multiply-add per angle (JAX ``ops/correlative.py``'s
    search angles), in ``fma_f32``'s form (each product of a small integer
    and the f32 step is exact in float64)."""
    ramp = torch.arange(n, dtype=torch.float64, device=start.device) * float(np.float32(step))
    return (ramp + start.double()).float()


def candidate_offsets(center_m, inv_res: float, half: float, n: int,
                      step: float) -> torch.Tensor:
    """A tier's candidate offsets in map cells, x and y (..., 2, n), from
    its centre's world position plus the map offset ``center_m`` (..., 2),
    as XLA compiles them inside the step, where the centre is mapped in
    the same fusion: ``center_m * inv_res - half`` (JAX ``models/
    grid_map.py``'s ``world_to_map_pose`` and ``ops/correlative.py``'s
    first offset) is one fused multiply-add, the centre never rounded on
    its own, and each offset one more (``angle_ramp``), both in
    ``fma_f32``'s form."""
    start = (center_m.double() * float(np.float32(inv_res))
             - float(np.float32(half))).float()
    return angle_ramp(start[..., None], n, step)


def _grid_tables(A: int, Nx: int, Ny: int, device) -> tuple:
    """Constants of an (A, Nx, Ny) candidate grid, per flat index f (made
    once per shape and device): its columns in ``tie_sums``' value table
    ``[1, xs, ys, cos, sin]`` (5, n), ``n - f`` (n,) (the larger, the earlier
    in flat order) and its window of ``XLA_REDUCE_WINDOW`` angles (n,)."""
    key = (A, Nx, Ny, str(device))
    if key not in _TABLES:
        if capturing_now(torch.device(device)):
            raise RuntimeError(f"tie_sums: the tables of a {(A, Nx, Ny)} grid are made "
                               "inside a capture (run the step once first)")
        f = np.arange(A * Nx * Ny)
        a, kx, ky = f // (Nx * Ny), f // Ny % Nx, f % Ny
        cols = np.stack([np.zeros_like(f), 1 + kx, 1 + Nx + ky, 1 + Nx + Ny + a,
                         1 + Nx + Ny + A + a])
        pad = -(-A // XLA_REDUCE_WINDOW) * XLA_REDUCE_WINDOW - A
        win = (a + pad // 2) // XLA_REDUCE_WINDOW
        _TABLES[key] = tuple(torch.as_tensor(v, device=device)
                             for v in (cols, f.size - f, win))
    return _TABLES[key]


def tie_sums(w, xs, ys, cos, sin) -> torch.Tensor:
    """The tie average's sums over the last three dimensions of ``w`` (...,
    A, Nx, Ny) — of ``w``, ``w * xs[kx]``, ``w * ys[ky]``, ``w * cos[a]``,
    ``w * sin[a]`` (``xs`` (..., Nx), ``ys`` (..., Ny), ``cos`` / ``sin``
    (..., A)) — in the order XLA sums them inside the compiled step (module
    docstring). ``w`` is zero but on the tied candidates, so only those
    terms change a sum: the first ``TIE_SLOTS`` of them in flat order are
    folded one at a time (one fused multiply-add per term; over more than
    32 angles a product rounded per term, each window of 32 angles summed
    on its own, then the windows' partials). Where more candidates tie, or
    a candidate dimension is longer than 32 (an order not mirrored; no tier
    of the shipped configurations has one), the plain sums. Returns (5,
    ...). About twenty elementwise operations, whatever the grid's size."""
    A, Nx, Ny = w.shape[-3:]
    n = A * Nx * Ny
    cols, later, win = _grid_tables(A, Nx, Ny, w.device)
    wf = w.reshape(*w.shape[:-3], 1, n)
    table = torch.cat([torch.ones_like(xs[..., :1]), xs, ys, cos, sin], -1)
    vals = table[..., cols]                            # (..., 5, n)
    terms = vals * wf                                  # the products, rounded
    plain = terms.sum(-1)
    if max(Nx, Ny) > XLA_REDUCE_WINDOW or n <= TIE_SLOTS:
        return plain.movedim(-1, 0)
    # the first TIE_SLOTS + 1 tied candidates in flat order (untied ones,
    # zero weight, fill the slots past the tie set)
    first, idx = torch.topk((wf[..., 0, :] != 0) * later, TIE_SLOTS + 1)
    over = first[..., TIE_SLOTS] > 0
    idx = idx[..., :TIE_SLOTS]
    at = idx[..., None, :].expand(*idx.shape[:-1], 5, TIE_SLOTS)
    if A <= XLA_REDUCE_WINDOW:
        # one f32 fused multiply-add per term (fma_f32's form): the products
        # exact in float64, each sum rounded in float64 and then to f32
        prods = wf.double().gather(-1, idx[..., None, :]) * vals.gather(-1, at)
        acc = prods[..., 0].float()
        for k in range(1, TIE_SLOTS):
            torch.add(prods[..., k], acc, out=acc)
    else:
        t = terms.gather(-1, at)
        # a term in a later window than the one before: that window's sum
        # joins the total first (multiplied by 0 or 1: exact)
        moved = (win[idx[..., 1:]] != win[idx[..., :-1]]).to(t.dtype)[..., None, :]
        keep = 1 - moved
        total, acc = torch.zeros_like(t[..., 0]), t[..., 0]
        for k in range(1, TIE_SLOTS):
            total = torch.addcmul(total, acc, moved[..., k - 1])
            acc = torch.addcmul(t[..., k], acc, keep[..., k - 1])
        acc = total + acc
    return torch.where(over[..., None], plain, acc).movedim(-1, 0)
