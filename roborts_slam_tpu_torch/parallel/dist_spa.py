"""Distributed SPA: the pose-graph Levenberg-Marquardt solve with its edges
sharded over a mesh axis.

Counterpart of the JAX package's ``parallel/dist_spa.py``. The edges
(residual blocks) are split into contiguous blocks, one per rank of the
axis; every rank runs the same LM/PCG iteration on its block, and the
normal-equation pieces — gradient, block-Jacobi diagonal, each CG
Hessian-vector product — and the cost are summed over the axis's group with
``all_reduce``. Node state (poses, CG vectors) is replicated, so after every
sum all ranks hold the same bits and advance in lockstep. The loops are the
single solve's fixed masked loops, launched eagerly (no CUDA graph): every
rank runs all ``max_iters`` LM iterations of ``cg_iters`` CG steps and so
makes the same all-reduces by construction, and its stopping flags, computed
from summed tensors only, stay on the device; nothing is read on the host.
Where the JAX package runs one SPMD program (``shard_map`` with ``psum``),
each rank here is its own process.

The math is backend/spa.py's ``lm_solve``; the sums are taken in another
order than the single solve's, so the two agree to float tolerance.
"""

from __future__ import annotations

import functools

import torch

from ..backend.spa import PoseGraphData, lm_solve
from .mesh import Mesh, replicate


def pad_edges_to(data: PoseGraphData, multiple: int) -> PoseGraphData:
    """Pad the edges to a multiple of ``multiple`` with disabled edges
    (``edge_mask`` False, zero measurement and information, edge (0, 0))."""
    e = data.edge_ij.shape[0]
    target = ((e + multiple - 1) // multiple) * multiple
    if target == e:
        return data
    pad = target - e

    def padded(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    return data._replace(edge_ij=padded(data.edge_ij), edge_rel=padded(data.edge_rel),
                         edge_info=padded(data.edge_info),
                         edge_mask=padded(data.edge_mask))


def solve_pose_graph_sharded(data: PoseGraphData, mesh: Mesh,
                             axis: str = "graph", max_iters: int = 50,
                             cg_iters: int = 100):
    """Run the LM solve with the edges sharded over ``axis``: this rank keeps
    its contiguous block of the padded edges, the nodes whole, all on the
    mesh's device. Every rank of the axis calls this with the same ``data``.
    Returns (poses, cost, iters) on every rank — the same on all of them,
    and equal to the single solve ``solve_pose_graph`` up to the order of
    float sums."""
    if not mesh.is_member:
        raise ValueError("this rank is outside the mesh")
    n, i = mesh.shape[axis], mesh.index[axis]
    data = pad_edges_to(data, n)
    e = data.edge_ij.shape[0] // n
    rows = slice(i * e, (i + 1) * e)
    local = replicate(mesh, data._replace(
        edge_ij=data.edge_ij[rows], edge_rel=data.edge_rel[rows],
        edge_info=data.edge_info[rows], edge_mask=data.edge_mask[rows]))
    reduce_fn = functools.partial(mesh.all_reduce, axis=axis)
    return lm_solve(local, max_iters=max_iters, cg_iters=cg_iters,
                    reduce_fn=reduce_fn, scalar_reduce_fn=reduce_fn)
