"""Distributed pose-graph solve over ranks of torch.distributed.

Usage:
  torchrun --nproc-per-node N examples/distributed_spa_torch.py [--nodes 1024]
      [--device cpu] [--max-iters 50] [--cg-iters 100]

Every rank builds the same noisy loop pose graph from a seed, solves it
alone, then solves it again with its edges sharded over all ranks
(all-reduced Gauss-Newton) and checks that both agree. ``--device cpu``
runs the ranks on the CPU over gloo; otherwise each rank takes its own card
and the ranks talk over NCCL. Rank 0 prints the result. Run without
``torchrun`` it is a single process (a mesh of one rank).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--device", default=None, help="cpu: gloo on the CPU (default: the card, NCCL)")
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--cg-iters", type=int, default=100)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from roborts_slam_tpu_torch.backend import spa
    from roborts_slam_tpu_torch.parallel.dist_spa import solve_pose_graph_sharded
    from roborts_slam_tpu_torch.parallel.mesh import make_mesh
    from roborts_slam_tpu_torch.parallel.multihost import (
        initialize_distributed, make_synthetic_loop_graph,
    )

    cpu = args.device == "cpu"
    initialize_distributed(backend="gloo" if cpu else None)
    mesh = make_mesh(axis_name="graph", device=args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"ranks: {mesh.size} ({'gloo, cpu' if cpu else 'nccl, ' + str(mesh.device)})")

    def timed(fn):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        out = fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return out, time.perf_counter() - t0

    n = args.nodes
    data = make_synthetic_loop_graph(n, device=mesh.device)
    (p1, c1, i1), t1 = timed(lambda: spa.solve_pose_graph(data, args.max_iters, args.cg_iters))
    say(f"single: cost {float(c1):.4f} in {i1} iters, {t1 * 1e3:.0f} ms")
    before = mesh.all_reduces
    (p2, c2, i2), t2 = timed(lambda: solve_pose_graph_sharded(
        data, mesh, axis="graph", max_iters=args.max_iters, cg_iters=args.cg_iters))
    say(f"{mesh.size}-rank sharded: cost {float(c2):.4f} in {i2} iters, "
        f"{t2 * 1e3:.0f} ms, {mesh.all_reduces - before} all-reduces")

    d = (p1 - p2).abs()
    d[:, 2] = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2])).abs()   # ±π agree
    err, dc = float(d.max()), abs(float(c1) - float(c2))
    say(f"max pose disagreement: {err:.2e}, cost {dc:.2e}")
    # the constraints are exact, so the optimal cost is near 0: the cost bar
    # is 1e-3 relative or 1e-6 absolute
    ok = err < 1e-3 and dc <= 1e-3 * abs(float(c1)) + 1e-6
    if dist.is_initialized():
        dist.destroy_process_group()
    if not ok:
        say("FAILED")
        return 1
    say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
