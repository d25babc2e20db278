"""The SPA solve's CG kernel (``ops/cuda/spa_pcg.cu``), what of it the CPU
can check: the incidence lists (``spa_pcg.incidence``) reproduce
``index_add_``'s segment sums bit for bit on padded graphs; the wrapper
refuses tensors off the card and counts its launches by shape; every bucket
from 64 to 8192 nodes with edges up to 2·bn fits one launch (``geometry``);
the solve program refuses a shape past one cluster; ``Backend.cg_steps_run``
counts the kernel's steps;
and the graphs of ``tests/data/spa_kernel_jax.npz`` (JAX's solves, which
the tests on the card hold the kernel's solve against) are ``loop_graph``'s
and hold the port's CPU solve within those tests' bars."""

import numpy as np
import pytest
import torch

import roborts_slam_tpu_torch.backend.processor as tproc
import roborts_slam_tpu_torch.backend.spa as tspa
from roborts_slam_tpu_torch.backend.pose_graph import PoseGraph
from roborts_slam_tpu_torch.config import SlamConfig
from roborts_slam_tpu_torch.ops.cuda import spa_pcg
from _torch_spa_graphs import FIELDS, FIXTURE, FIXTURE_GRAPHS, loop_graph

torch.set_num_threads(1)


def _padded(n, e, seed):
    """A graph of ``n`` nodes round a circle and ``e`` edges (the odometry
    chain and random loop edges), packed by ``PoseGraph.as_solver_data``:
    padded to JAX's buckets, padding edges at (0, 0)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([5 * np.cos(t), 5 * np.sin(t), np.arctan2(np.cos(t), -np.sin(t))], -1)
    g = PoseGraph(3.0, 3)
    for _ in range(n):
        g.add_vertex()
    pairs = [(i, i + 1) for i in range(n - 1)]
    while len(pairs) < e:
        i, j = sorted(int(v) for v in rng.choice(n, 2, replace=False))
        if j - i > 1 and (i, j) not in pairs:
            pairs.append((i, j))
    cov = np.diag([1e-3, 1e-3, 1e-4])
    for i, j in pairs:
        assert g.add_edge(i, j, gt[i] + rng.normal(0, 0.01, 3) * [1, 1, 0.3],
                          gt[j] + rng.normal(0, 0.01, 3) * [1, 1, 0.3], cov)
    init = gt + rng.normal(0, 0.05, gt.shape) * [1, 1, 0.3]
    init[0] = gt[0]
    return g.as_solver_data(init, "cpu")


BUCKET_EDGES = [(40, 45), (63, 62), (64, 65), (65, 129), (100, 140), (300, 513)]


@pytest.mark.parametrize("n,e", BUCKET_EDGES)
def test_incidence_reproduces_index_add(n, e):
    """Every bucket edge and every padding edge at (0, 0) in the lists; the
    sums in list order equal ``_segment_sum`` (``index_add_``) bit for bit,
    node 0 with its padding entries included."""
    data = _padded(n, e, seed=n + e)
    pn, pe = data.poses.shape[0], data.edge_ij.shape[0]
    ptr, entries = spa_pcg.incidence(data.edge_ij, pn)
    assert ptr.dtype == entries.dtype == torch.int32
    assert ptr.shape == (pn + 1,) and entries.shape == (2 * pe,)
    assert int(ptr[0]) == 0 and int(ptr[-1]) == 2 * pe
    assert torch.equal(torch.sort(entries.long()).values, torch.arange(2 * pe))
    assert int(ptr[1]) - int(ptr[0]) == 2 * (pe - e) + int((data.edge_ij[:e] == 0).sum())
    gen = torch.Generator().manual_seed(n)
    for _ in range(3):
        ga = torch.randn((pe, 3), generator=gen)
        gb = torch.randn((pe, 3), generator=gen)
        want = tspa._segment_sum(data.poses, data, ga, gb)
        assert torch.equal(spa_pcg.incidence_segment_sum(ga, gb, ptr, entries), want)


def test_pcg_refuses_cpu_tensors():
    """The kernel has no CPU version and no fallback: tensors off the card
    raise before anything is built or launched."""
    data = _padded(40, 45, seed=1)
    gauge = tspa._gauge_mask(data)
    lin = tspa._linearize(data.poses, data, gauge)
    b = -tspa._gradient(lin, data.poses, data)
    lam = torch.full((), 1e-4)
    ptr, entries = spa_pcg.incidence(data.edge_ij, data.poses.shape[0])
    with pytest.raises(ValueError, match="on the card"):
        spa_pcg.pcg(lin.ja, lin.jb, lin.info, lin.gauge, tspa._preconditioner(lin, data, lam),
                    b, lam, torch.zeros((), dtype=torch.bool), data.edge_ij, ptr, entries,
                    100, 1e-6)


def test_launches_counted_by_shape():
    """A launch counts once in ``pcg_launches`` and under its (nodes, edges)
    in ``pcg_shapes``; inside a capture the count waits for the replays."""
    from roborts_slam_tpu_torch.ops.cuda import launch

    before, shapes = spa_pcg.pcg_launches, dict(spa_pcg.pcg_shapes)
    launch.counted(spa_pcg._count, (512, 1024))
    assert spa_pcg.pcg_launches == before + 1
    assert spa_pcg.pcg_shapes[(512, 1024)] == shapes.get((512, 1024), 0) + 1
    recorded: list = []
    with launch.capturing(recorded, {}):
        launch.counted(spa_pcg._count, (64, 128))
    assert spa_pcg.pcg_launches == before + 1
    assert recorded == [(spa_pcg._count, ((64, 128),))]


@pytest.mark.parametrize("bn", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("factor", [1, 2])
def test_geometry_holds_every_bucket(bn, factor):
    """One launch holds every bucket up to 8192 nodes with edges bn and
    2·bn: one cluster of up to 8 CTAs, every node and edge owned, the
    kernel's instantiations, within a block's shared memory."""
    pe = factor * bn
    g = spa_pcg.geometry(bn, pe)
    assert g is not None and spa_pcg.holds(bn, pe)
    assert g.cluster in (1, 2, 4, 8) and g.cluster == max(1, bn // 1024, pe // 2048)
    assert g.threads % 32 == 0 and 32 <= g.threads <= spa_pcg.MAX_THREADS
    assert g.cluster * g.node_span >= bn and g.cluster * g.edge_span >= pe
    assert g.node_span <= spa_pcg.NODE_SPAN and g.edge_span <= spa_pcg.EDGE_SPAN
    assert g.npt in (1, 2) and g.ept in spa_pcg.EDGES_PER_THREAD
    assert g.threads * g.npt >= g.node_span and g.threads * g.ept >= g.edge_span
    assert g.smem_bytes == 4 * (15 * g.node_span + 6 * g.edge_span + spa_pcg.SLOT_FLOATS)
    assert g.smem_bytes <= 232_448


def test_geometry_past_one_cluster():
    assert spa_pcg.geometry(16384, 16384) is None and not spa_pcg.holds(8192, 32768)
    assert spa_pcg.holds(8192, 16384) and spa_pcg.holds(100, 1000)
    with pytest.raises(ValueError):
        spa_pcg.geometry(0, 64)


def test_solve_program_picks_its_cg_by_shape():
    """A program's CG is the kernel at every shape one cluster holds, with
    its incidence lists' buffers; a shape past it is refused."""
    cpu = torch.device("cpu")
    prog = tspa.SolveProgram(cpu, 2048, 4096, 50, 100)
    assert prog.ptr.shape == (2049,) and prog.entries.shape == (8192,)
    assert tspa.closure_path("cuda") == "graph: cg kernel"
    tspa.SolveProgram(cpu, 8192, 16384, 50, 100)
    for pn, pe in ((16384, 16384), (8192, 32768)):
        with pytest.raises(ValueError, match="one cluster"):
            tspa.SolveProgram(cpu, pn, pe, 50, 100)


class _Store:
    """What ``Backend._solve_and_correct`` reads of the engine's store."""

    def __init__(self, poses):
        self.poses = poses
        self.device = torch.device("cpu")

    def poses_array(self):
        return self.poses


class _Program:
    """A solve program as ``solve_packed`` returns it."""

    name, last, last_capture_s = "solve_64x64", "replay", 0.0


@pytest.mark.parametrize("program", [True, False])
def test_cg_steps_run_counts_the_kernels_steps(monkeypatch, program):
    """``cg_steps_run`` adds the steps the solve took where a program ran it
    (its CG the kernel: the packed vector's CG slot), 50 × 100 where the
    masked loop ran eagerly (``solve_packed`` returns no program)."""
    spec = tproc.BackendSpec(config=SlamConfig(), coarse_spec=None, fine_spec=None,
                             pub_spec=None, matcher=None, max_chain_scans=0)
    n = 30
    data = _padded(n, 36, seed=5)
    back = tproc.Backend(spec, _Store(data.poses.numpy()[:n].astype(np.float64)))
    for _ in range(n):
        back.graph.add_vertex()
    poses = back.store.poses
    for i, j in data.edge_ij[:36].tolist():
        back.graph.add_edge(i, j, poses[i], poses[j], np.diag([1e-3, 1e-3, 1e-4]))

    def solve(d, max_iters, cg_iters):
        packed = tspa.solve_packed(d, max_iters, cg_iters)[0]
        return packed, _Program() if program else None

    monkeypatch.setattr(tproc, "solve_packed", solve)
    for k in (1, 2):
        back.force_optimize()
        steps = back.last_solve["cg_steps"]
        assert 0 < steps <= 50 * 100
        assert back.cg_steps_needed <= back.cg_steps_run
    want = back.cg_steps_needed if program else 2 * 50 * 100
    assert back.cg_steps_run == want


@pytest.mark.parametrize("k", range(len(FIXTURE_GRAPHS)))
def test_fixture_graphs_hold_the_cpu_solve(k):
    """The stored graph is ``loop_graph``'s, and the port's own solve on the
    CPU (the masked loops) meets the bars the card's tests hold the kernel's
    solve to against the stored JAX solve: 1e-4 in position and angle, the
    cost within 1e-5 relative."""
    fx = np.load(FIXTURE)
    bn, pe, seed = FIXTURE_GRAPHS[k]
    made = loop_graph(bn, pe, seed)
    for f in FIELDS:
        np.testing.assert_array_equal(fx[f"g{k}_{f}"], made[f], err_msg=f)
    data = tspa.PoseGraphData(**{f: torch.as_tensor(made[f]) for f in FIELDS})
    poses, cost, _ = tspa.solve_pose_graph(data)
    n = int(made["node_mask"].sum())
    got, want = poses.numpy()[:n], fx[f"g{k}_jax_poses"][:n]
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
    d = np.arctan2(np.sin(got[:, 2] - want[:, 2]), np.cos(got[:, 2] - want[:, 2]))
    assert np.abs(d).max() <= 1e-4
    jc = float(fx[f"g{k}_jax_cost"])
    assert abs(float(cost) - jc) <= 1e-5 * abs(jc)
