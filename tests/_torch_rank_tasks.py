"""Programs run by the ranks that ``tests/test_torch_parallel.py`` starts
with ``roborts_slam_tpu_torch.parallel.multihost.launch_local`` (imported in
those processes, not collected). They import the port only: the pytest
process holds their results against the JAX package."""

import time

import torch

import roborts_slam_tpu_torch.backend.spa as spa
from roborts_slam_tpu_torch.backend.processor import chain_match_batch_gather
from roborts_slam_tpu_torch.parallel.dist_spa import solve_pose_graph_sharded
from roborts_slam_tpu_torch.parallel.mesh import make_mesh
from roborts_slam_tpu_torch.parallel.multihost import (
    global_mesh, scaling_run, spa_scaling_workload,
)
from roborts_slam_tpu_torch.parallel.sharded_match import (
    make_batched_chain_matcher, make_batched_scan_matcher,
    make_sharded_chain_matcher_gather,
)


def sharded_spa(graphs, max_iters=50, cg_iters=100):
    """Each graph solved with its edges sharded over every rank."""
    mesh = make_mesh(axis_name="graph", device="cpu")
    out = []
    for data in graphs:
        syncs, reduces = spa.host_syncs, mesh.all_reduces
        poses, cost, iters = solve_pose_graph_sharded(data, mesh, "graph",
                                                      max_iters, cg_iters)
        out.append({"poses": poses, "cost": cost, "iters": iters,
                    "host_syncs": spa.host_syncs - syncs,
                    "all_reduces": mesh.all_reduces - reduces})
    return out


def everything_on_two(graphs, budget, chain_problem, gather_problem, scan_problem):
    """The W=2 run: the sharded SPA (at ``budget`` = (LM, CG) iterations,
    and the first graph at the full 50 / 100), the three sharded matchers
    and the mesh and scaling harness, one process group for all of them."""
    out = {"spa": sharded_spa(graphs, *budget),
           "spa_full": sharded_spa(graphs[:1])[0]}
    mesh = make_mesh(axis_name="data", device="cpu")
    fn_args, arrays = chain_problem
    out["chain"] = make_batched_chain_matcher(*fn_args, mesh=mesh)(*arrays)
    spec, operands = gather_problem
    out["gather"] = make_sharded_chain_matcher_gather(spec, mesh)(*operands)
    own = slice(4 * mesh.index["data"], 4 * mesh.index["data"] + 4)
    out["gather_own_block"] = chain_match_batch_gather(
        spec, *operands[:3], operands[3][own], *operands[4:6], operands[6][own],
        *operands[7:])
    fn_args, operands = scan_problem
    out["scan"] = make_batched_scan_matcher(*fn_args, mesh=mesh)(*operands)
    out["data_all_reduces"] = mesh.all_reduces
    g = global_mesh(device="cpu")
    out["global_mesh"] = (g.axis_names, g.shape, g.index)
    wf = spa_scaling_workload(n_nodes=64, max_iters=3, cg_iters=5)
    out["points"] = [(p.n_devices, p.seconds, p.throughput, p.efficiency)
                     for p in scaling_run(wf, [1, 2], reps=1, device="cpu")]
    return out


def fail_on_rank_1():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return 0


def hang_on_rank_0():
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    if torch.distributed.get_rank() == 0:
        torch.distributed.all_reduce(torch.zeros(1))
    else:
        time.sleep(600)
