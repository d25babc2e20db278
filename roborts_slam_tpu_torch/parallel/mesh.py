"""Named mesh axes over ``torch.distributed`` process groups.

Counterpart of the JAX package's ``parallel/mesh.py``. A JAX ``Mesh`` is a
grid of devices with named axes, driven by one program that the compiler
partitions. Here every rank is a process with one device, and a ``Mesh`` is
this rank's view of a grid of ranks: for each named axis, the process group
of the ranks that share this rank's other coordinates, the axis size and this
rank's index along it. Sharded code takes its own rows (``shard_batch``) and
sums over an axis with ``Mesh.all_reduce``. The axes are

- ``data``  — batch fan-out: chain matches, loop-closure candidate scoring,
  batches of scans;
- ``graph`` — pose-graph edge sharding for the distributed SPA solve.

Ranks are laid out row-major over the axes, so the last axis (``graph`` in a
2-D mesh) groups adjacent ranks: the ranks of one host under ``torchrun``'s
numbering. A mesh may cover fewer ranks than the world; ranks outside it get
a mesh whose ``is_member`` is false. ``torch.distributed.new_group`` is
collective over the whole world, so every rank makes every group of a mesh,
in the same order, members or not. Without an initialised process group a
mesh has one rank and its reductions are the identity.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a grid of ranks with named axes."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]            # axis -> number of ranks along it
    device: torch.device             # this rank's device
    groups: dict[str, object]        # axis -> process group (None: no process group)
    index: dict[str, int]            # axis -> this rank's coordinate; -1 outside the mesh
    all_reduces: int = 0             # collectives issued through this mesh so far

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_member(self) -> bool:
        return all(i >= 0 for i in self.index.values())

    def all_reduce(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``tensor`` in place over the ranks of this rank's ``axis``
        group and return it. Every rank of the group ends with the same bits
        (the collective reduces each element once and hands the sum round)."""
        group = self.groups[axis]
        if group is not None:
            if not tensor.is_contiguous():
                raise ValueError("all_reduce needs a contiguous tensor")
            dist.all_reduce(tensor.view(-1), op=dist.ReduceOp.SUM, group=group)
            self.all_reduces += 1
        return tensor

    def gather_rows(self, local: torch.Tensor, batch: int, axis: str) -> torch.Tensor:
        """The ``(batch, ...)`` tensor whose rows ``i*b .. (i+1)*b - 1`` are
        rank ``i``'s ``local`` rows (``b = batch / axis size``), on every rank
        of this rank's ``axis`` group: each rank writes its rows into zeros and
        the buffers are summed. Adding zeros is exact, so each row keeps its
        bits, and the sum is an all-reduce, which gloo also does for tensors
        on the card (its ``all_gather`` does not)."""
        n = self.shape[axis]
        b = batch // n
        if local.shape[0] != b or b * n != batch:
            raise ValueError(f"{local.shape[0]} rows per rank for {batch} over {n}")
        if self.groups[axis] is None:
            return local
        out = torch.zeros((batch, *local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        i = self.index[axis]
        out[i * b:(i + 1) * b] = local
        return self.all_reduce(out, axis)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple[int, int]:
    """(world size, this rank), (1, 0) without a process group."""
    if _initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _resolve_device(device) -> torch.device:
    from ..engine import resolve_device

    return resolve_device(device)


def _grid(shape: dict[str, int], device) -> Mesh:
    world, rank = _world()
    dims = tuple(shape.values())
    total = math.prod(dims)
    if total < 1 or total > world:
        raise ValueError(f"a mesh of {dims} needs {total} ranks; the world has {world}")
    names = tuple(shape)
    coords = np.unravel_index(rank, dims) if rank < total else None
    groups: dict[str, object] = {}
    grid = np.arange(total).reshape(dims)
    for ax, name in enumerate(names):
        groups[name] = None
        if not _initialized():
            continue
        # every line of ranks along this axis, made by every rank in one order
        for line in np.moveaxis(grid, ax, -1).reshape(-1, dims[ax]).tolist():
            group = dist.new_group(ranks=line)
            if rank in line:
                groups[name] = group
    index = {name: int(coords[ax]) if coords is not None else -1
             for ax, name in enumerate(names)}
    return Mesh(axis_names=names, shape=dict(shape),
                device=_resolve_device(device), groups=groups, index=index)


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all by default).
    ``device``: this rank's device (None: the card, or raises)."""
    world, _ = _world()
    return _grid({axis_name: world if n_devices is None else n_devices}, device)


def make_mesh_2d(n_data: int, n_graph: int, device=None) -> Mesh:
    """A (data, graph) mesh over the first ``n_data * n_graph`` ranks."""
    return _grid({"data": n_data, "graph": n_graph}, device)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):       # NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: Mesh, tree, axis_name: str = "data"):
    """This rank's contiguous block of the leading dimension of every tensor
    in ``tree``, on the mesh's device. The leading dimension must be a
    multiple of the axis size."""
    n, i = mesh.shape[axis_name], mesh.index[axis_name]
    if i < 0:
        raise ValueError("this rank is outside the mesh")

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of {n}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b].to(mesh.device)

    return _tree_map(rows, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` whole, on the mesh's device (each rank holds
    its own copy)."""
    return _tree_map(lambda x: x.to(mesh.device), tree)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)
