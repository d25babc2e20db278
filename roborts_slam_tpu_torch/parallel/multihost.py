"""Multi-process bring-up, the scaling harness and a launcher of local ranks.

Counterpart of the JAX package's ``parallel/multihost.py``. The reference has
no multi-process story (one process, four threads); this is the scale-out
path: ``torch.distributed`` across processes, one rank per device, and
meshes whose ``data`` (batch fan-out) and ``graph`` (pose-graph edge
sharding) axes span the ranks, the ``graph`` axis — which carries the
per-CG-step all-reduces of the distributed SPA solve — kept within a host.

Testable without a cluster: ``launch_local`` starts W ranks on this host
(gloo on the CPU, where the JAX package fakes devices with
``--xla_force_host_platform_device_count``), and ``scaling_run`` runs the
same sharded program at growing rank counts.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..backend.spa import PoseGraphData
from .dist_spa import solve_pose_graph_sharded
from .mesh import Mesh, _initialized, _tree_map, _world, make_mesh, make_mesh_2d


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> bool:
    """Join the process group: ``coordinator_address`` ("host:port" or a
    ``tcp://`` URL, rank 0 listens there), ``num_processes`` ranks, this one
    ``process_id``. Without arguments the launcher's environment is read
    (``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``); without that either, this is a single-process run and
    nothing is joined. ``backend`` None is NCCL on the card, one card per
    rank (``LOCAL_RANK``), and raises without a card; gloo (the CPU, or
    several ranks sharing one card) must be asked for. Returns whether a
    process group is up."""
    if _initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False                     # single-process run
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("give the coordinator address, the number of "
                             "processes and this process's id together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for NCCL: pass backend='gloo' "
                               "to run the ranks on the CPU")
        backend = "nccl"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank)
    return True


def global_mesh(data_axis: int | None = None, graph_axis: int | None = None,
                device=None) -> Mesh:
    """2-D (data, graph) mesh over every rank. ``graph`` (the
    latency-sensitive all-reduce axis) is filled with adjacent ranks, by
    default the ranks of one host (``LOCAL_WORLD_SIZE``, else the world);
    ``data`` spans the rest (across hosts)."""
    world, _ = _world()
    if graph_axis is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        graph_axis = min(world, max(1, local))
    if data_axis is None:
        data_axis = world // graph_axis
    if data_axis * graph_axis != world:
        raise ValueError(f"({data_axis}, {graph_axis}) does not cover {world} ranks")
    return make_mesh_2d(data_axis, graph_axis, device)


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    seconds: float
    throughput: float
    efficiency: float   # vs 1-device throughput x n


def scaling_run(work_fn, sizes: list[int], reps: int = 3,
                device=None) -> list[ScalingPoint]:
    """Measure ``work_fn(mesh) -> items_done`` on meshes of the first ``n``
    ranks for each ``n`` of ``sizes``. ``work_fn`` must submit the same total
    work at every size (strong scaling) and block until it is done. Every
    rank calls this (the meshes are made collectively); the ranks outside a
    mesh skip it, and all meet at a barrier after each size. Rank 0 is in
    every mesh, so its list has a point for every size."""
    points = []
    base = None
    for n in sizes:
        mesh = make_mesh(n, device=device)
        if mesh.is_member:
            work_fn(mesh)                      # warm
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                items = work_fn(mesh)
                times.append(time.perf_counter() - t0)
            sec = float(np.median(times))
            thr = items / sec
            if base is None:
                base = thr
            points.append(ScalingPoint(n_devices=n, seconds=sec, throughput=thr,
                                       efficiency=thr / (base * n)))
        if _initialized():
            dist.barrier()
    return points


def make_synthetic_loop_graph(n_nodes: int, noise: float = 0.05,
                              loop_frac: float = 0.25, radius: float = 10.0,
                              seed: int = 0, device=None) -> PoseGraphData:
    """Noisy circular pose graph (odometry chain + random loop edges) with
    exact relative-pose constraints — the distributed-SPA benchmark and
    demonstration workload. Made in NumPy from ``seed``, then tensors on
    ``device`` (None: the card, or raises)."""
    from ..engine import resolve_device

    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    gt = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                   theta + np.pi / 2], -1)
    noisy = gt + rng.normal(0, noise, gt.shape)
    noisy[0] = gt[0]
    eij = [(i, (i + 1) % n_nodes) for i in range(n_nodes)]
    for _ in range(int(n_nodes * loop_frac)):
        i, j = sorted(rng.integers(0, n_nodes, 2))
        if j - i > 2:
            eij.append((i, j))
    eij = np.array(eij, np.int64)

    def rel(a, b):
        d = b - a
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])

    erel = np.stack([rel(gt[i], gt[j]) for i, j in eij])
    dev = resolve_device(device)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return PoseGraphData(
        poses=t(noisy, torch.float32),
        node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        edge_ij=t(eij, torch.int64),
        edge_rel=t(erel, torch.float32),
        edge_info=t(np.broadcast_to(np.eye(3, dtype=np.float32) * 20.0,
                                    (eij.shape[0], 3, 3)).copy(), torch.float32),
        edge_mask=torch.ones(eij.shape[0], dtype=torch.bool, device=dev),
    )


def spa_scaling_workload(n_nodes: int = 512, seed: int = 0, max_iters: int = 10,
                         cg_iters: int = 25):
    """Returns ``work_fn`` for ``scaling_run``: one fixed loop pose graph
    solved with its edges sharded over the mesh's axis, on the mesh's device
    (the distributed-SPA benchmark)."""
    data = make_synthetic_loop_graph(n_nodes, seed=seed, device="cpu")

    def work_fn(mesh):
        p, c, it = solve_pose_graph_sharded(data, mesh, axis=mesh.axis_names[0],
                                            max_iters=max_iters, cg_iters=cg_iters)
        if p.is_cuda:
            torch.cuda.synchronize(p.device)
        return data.edge_ij.shape[0] * max_iters   # edge-iterations done
    return work_fn


# ---- local ranks ----

@dataclasses.dataclass
class RankResult:
    """What one rank of ``launch_local`` handed back."""

    rank: int
    result: object             # the target's return value
    seconds: float             # the target's wall time in that rank
    launch_shapes: dict        # kernel launches by shape: {"corr"|"mark"|"check": {shape: n}}


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(target: str, world_size: int, args: tuple = (),
                 kwargs: dict | None = None, backend: str | None = None,
                 timeout: float = 120.0) -> list[RankResult]:
    """Start ``world_size`` ranks on this host, each a fresh Python process
    that joins the group (``initialize_distributed`` on a free loopback port,
    ``backend`` as there: None is NCCL, one card per rank) and calls
    ``target(*args, **kwargs)`` (``"package.module:function"``, importable
    from this checkout). Returns each rank's result, in rank order, with the
    kernel launches the rank made by shape (the wrappers count per process).
    Each rank takes one CPU thread (W ranks share this host's cores). The
    ranks' output goes to files, never to this process's stdout. A rank that
    fails, or ranks that have not all finished after ``timeout`` seconds, end
    every rank and raise."""
    root = str(Path(__file__).resolve().parents[2])
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        task = os.path.join(tmp, "task.pt")
        torch.save({"target": target, "args": tuple(args), "kwargs": dict(kwargs or {}),
                    "address": f"127.0.0.1:{free_port()}", "world_size": world_size,
                    "backend": backend}, task)
        env = dict(os.environ, LOCAL_WORLD_SIZE=str(world_size),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs, logs = [], []
        try:
            for rank in range(world_size):
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "roborts_slam_tpu_torch.parallel.multihost",
                     task, str(rank)],
                    env=dict(env, LOCAL_RANK=str(rank)), cwd=root,
                    stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} exited with {codes[failed[0]]}:\n"
                                       + _tail(logs[failed[0]]))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {[r for r, c in enumerate(codes) if c is None]} still "
                        f"running after {timeout} s:\n" + _tail(logs[0]))
                time.sleep(0.05)
            out = []
            for rank in range(world_size):
                got = torch.load(os.path.join(tmp, f"rank{rank}.pt"), weights_only=False)
                out.append(RankResult(rank=rank, **got))
            return out
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()


def _tail(log, n: int = 4000) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-n:]


def _to_host(tree):
    return _tree_map(lambda x: x.detach().cpu(), tree)


def _rank_main(task_path: str, rank: int) -> None:
    """The body of one rank of ``launch_local``."""
    from ..ops.cuda import correlation, raycarve

    task = torch.load(task_path, weights_only=False)
    module, name = task["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    initialize_distributed(task["address"], task["world_size"], rank, task["backend"])
    try:
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        result = fn(*task["args"], **task["kwargs"])
        seconds = time.perf_counter() - t0
        shapes = {"corr": dict(correlation.launch_shapes),
                  "mark": dict(raycarve.mark_shapes),
                  "check": dict(raycarve.check_shapes)}
        out = os.path.join(os.path.dirname(task_path), f"rank{rank}.pt")
        torch.save({"result": _to_host(result), "seconds": seconds,
                    "launch_shapes": shapes}, out + ".tmp")
        os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
