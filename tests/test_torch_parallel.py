"""Port vs JAX package: ``parallel/`` on ``torch.distributed``.

The sharded SPA and the sharded matchers run in 2, 3 and 4 local ranks on
gloo (``multihost.launch_local``; the ranks run
``tests/_torch_rank_tasks.py``, which imports the port only) and are held
here against the port's single-process call and against the JAX package's
functions on the same NumPy inputs. The JAX side runs as its own tests run
it on the CPU: the plain XLA path, ``mesh=None``. Every spawn has its own
timeout, so a deadlock fails its test instead of hanging the run.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.backend.spa as jspa
import roborts_slam_tpu.parallel.dist_spa as jdist
import roborts_slam_tpu.parallel.mesh as jmesh
import roborts_slam_tpu.parallel.multihost as jmh
import roborts_slam_tpu.parallel.sharded_match as jsm
import roborts_slam_tpu_torch.backend.spa as tspa
import roborts_slam_tpu_torch.parallel.dist_spa as tdist
import roborts_slam_tpu_torch.parallel.mesh as tmesh
import roborts_slam_tpu_torch.parallel.multihost as tmh
import roborts_slam_tpu_torch.parallel.sharded_match as tsm
from tests._mp_matcher_fixture import build_matcher_problem
from tests.test_torch_spa import _both, _make_loop_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
TASKS = "tests._torch_rank_tasks"
SPAWN_TIMEOUT = 55.0        # seconds a spawn may take before its ranks are ended

# the SPA bars of tests/test_parallel.py:22-24: cost within 1e-3 relative,
# poses within 1e-3 (sums over shards are taken in another order)
COST_RTOL, POSE_ATOL = 1e-3, 1e-3
# LM / CG iterations of the solves over 2, 3 and 4 ranks (spa_scaling_workload's;
# a gloo all-reduce costs 0.2-0.6 ms here, and the full 50 / 100 makes ~3300
# of them a graph): the full budget runs once, over two ranks
BUDGET = (10, 25)


def _graphs():
    """The graph of tests/test_parallel.py (48 nodes, noise 0.06, seed 11),
    padded to 64 nodes / 128 edges (uneven over 3 ranks), and the same graph
    unpadded (49 edges: uneven over 2, 3 and 4 ranks)."""
    padded = _make_loop_graph(n=48, noise=0.06, seed=11)[0]
    bare = _make_loop_graph(n=48, noise=0.06, seed=11, pad_n=48, pad_e=49)[0]
    return [padded, bare]


def _port_spec(jspec):
    import roborts_slam_tpu_torch.models.grid_map as tgm

    return tgm.ProbMapSpec(**dataclasses.asdict(jspec))


def _port_matcher(jm):
    """The port's MatcherParams with the fields of the JAX one."""
    import roborts_slam_tpu_torch.frontend.matchers as tmat
    import roborts_slam_tpu_torch.ops.correlative as tcor
    import roborts_slam_tpu_torch.ops.gauss_newton as tgn

    tier = lambda p: tcor.CorrelativeParams(**dataclasses.asdict(p))
    assert jm.bnb is None
    return tmat.MatcherParams(
        coarse=tier(jm.coarse), fine=tier(jm.fine), super_fine=tier(jm.super_fine),
        optimize=tgn.OptimizeParams(**dataclasses.asdict(jm.optimize)),
        use_optimize_scan_match=jm.use_optimize_scan_match,
        optimize_failed_cost=jm.optimize_failed_cost)


def _chain_problem():
    """tests/_mp_matcher_fixture.py's 4-row problem: the JAX operands and
    the port's."""
    (coarse, fine, matcher, blur_c, blur_f), arrays = build_matcher_problem()
    port_args = (_port_spec(coarse), _port_spec(fine), _port_matcher(matcher),
                 blur_c, blur_f)
    return ((coarse, fine, matcher, blur_c, blur_f), arrays,
            (port_args, tuple(torch.as_tensor(a) for a in arrays)))


def _gather_problem():
    """``configs/simulation.yaml`` narrowed as tests/test_parallel.py:113-115
    narrows the reference YAML (missing here); the store, chain ids and pub
    map of tests/test_parallel.py:119-134. Returns the JAX backend spec, the
    port's, and the NumPy operands."""
    import roborts_slam_tpu.backend.processor as jbp
    import roborts_slam_tpu.config as jcfg
    import roborts_slam_tpu.models.grid_map as jgm
    import roborts_slam_tpu_torch.backend.processor as tbp
    import roborts_slam_tpu_torch.config as tcfg
    import roborts_slam_tpu_torch.models.grid_map as tgm

    narrow = dict(max_points=64, max_chain_scans=4, coarse_map_resolution=0.08,
                  fine_map_resolution=0.04)
    laser_range = 3.0
    jc = jcfg.load_config(SIM_YAML).replace(**narrow)
    tc = tcfg.load_config(SIM_YAML).replace(**narrow)
    jb = jbp.BackendSpec.from_config(jc, laser_range, jgm.pub_map_spec(jc, laser_range, 10.0))
    tb = tbp.BackendSpec.from_config(tc, laser_range, tgm.pub_map_spec(tc, laser_range, 10.0))
    rng = np.random.default_rng(7)
    cap, P, B, K = 32, 64, 8, 4
    pub = tb.pub_spec
    ids = rng.integers(0, cap - 1, (B, K)).astype(np.int64)
    ids[2, 2:] = -1                      # padded chain
    arrays = dict(
        all_pts=rng.uniform(-2, 2, (cap, P, 2)).astype(np.float32),
        all_msk=np.ones((cap, P), bool), all_nv=np.full((cap,), P, np.int32),
        all_poses=rng.uniform(-1, 1, (cap, 3)).astype(np.float32), ids=ids,
        inits=rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32),
        center=np.array([0.1, -0.2, 0.3], np.float32),
        hits=np.zeros((pub.height, pub.width), np.float32),
        passes=np.zeros((pub.height, pub.width), np.float32),
        pub_off=np.array([5.0, 5.0], np.float32))
    return jb, tb, arrays


def _port_gather_operands(a, scan_id=1):
    t = torch.as_tensor
    return (t(a["all_pts"]), t(a["all_msk"]), t(a["all_poses"]), t(a["ids"]), scan_id,
            int(a["all_nv"][scan_id]), t(a["inits"]), t(a["center"]), t(a["hits"]),
            t(a["passes"]), t(a["pub_off"]))


def _scan_problem():
    """tests/test_parallel.py:27-79: an ellipse scan stamped into a 512²
    fine and a 128² coarse map by the JAX package, eight perturbed starts."""
    import roborts_slam_tpu.config as jcfg
    import roborts_slam_tpu.frontend.matchers as jmat
    import roborts_slam_tpu.models.grid_map as jgm
    import roborts_slam_tpu.ops.raster as jr

    cfg = jcfg.SlamConfig(
        use_optimize_scan_match=False,
        coarse_search_space_size=0.4, coarse_search_space_resolution=0.05,
        coarse_search_angle_offset=0.175, coarse_search_angle_resolution=0.0349,
        fine_search_space_size=0.1, fine_search_space_resolution=0.02,
        fine_search_angle_offset=0.0698, fine_search_angle_resolution=0.0349,
        super_fine_search_space_size=0.02, super_fine_search_space_resolution=0.01,
        super_fine_search_angle_offset=0.0349,
        super_fine_search_angle_resolution=0.00349)
    matcher = jmat.MatcherParams.from_config(cfg)
    fine_spec = jgm.ProbMapSpec(0.02, 512, 512, 0.05, 0.88)
    coarse_spec = jgm.ProbMapSpec(0.08, 128, 128, 0.24, 0.88)
    t = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    P = 128
    points = np.zeros((P, 2), np.float32)
    points[:100] = np.stack([2.5 * np.cos(t), 1.5 * np.sin(t)], -1)
    mask = np.zeros(P, bool)
    mask[:100] = True
    fine = jr.stamp_scan(fine_spec, jgm.make_prob_map(fine_spec, [5.12, 5.12]),
                         jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))
    coarse = jr.stamp_scan(coarse_spec, jgm.make_prob_map(coarse_spec, [5.12, 5.12]),
                           jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))
    B = 8
    inits = np.random.default_rng(0).uniform(-0.08, 0.08, size=(B, 3)).astype(np.float32)
    operands = [np.array(fine.probs), np.array(fine.offset), np.array(coarse.probs),
                np.array(coarse.offset), np.tile(points[None], (B, 1, 1)),
                np.tile(mask[None], (B, 1)), np.full(B, 100, np.int32), inits]
    jax_args = (fine_spec, coarse_spec, matcher)
    port_args = (_port_spec(fine_spec), _port_spec(coarse_spec), _port_matcher(matcher))
    return jax_args, operands, (port_args, tuple(torch.as_tensor(a) for a in operands))


def _td(arrays):
    return _both(arrays)[1]


@pytest.fixture(scope="module")
def problems():
    return {"graphs": _graphs(), "chain": _chain_problem(), "gather": _gather_problem(),
            "scan": _scan_problem()}


@pytest.fixture(scope="module")
def single_solves(problems):
    """Per (graph, budget): the port's single solve and JAX
    ``solve_pose_graph`` as (poses, cost) pairs."""
    out = {}
    for k, arrays in enumerate(problems["graphs"]):
        jd, td = _both(arrays)
        for budget in (BUDGET, (50, 100)):
            if k and budget != BUDGET:
                continue
            tp, tc, _ = tspa.solve_pose_graph(td, *budget)
            jp, jc, _ = jspa.solve_pose_graph(jd, *budget)
            out[k, budget] = [(tp, tc), (jp, jc)]
    return out


def _check_sharded(ranks, refs, n):
    """Ranks bit-equal to each other; the solve within the bars of every
    reference; all-reduces and host reads made in lockstep."""
    first = ranks[0]
    for other in ranks[1:]:
        assert torch.equal(other["poses"], first["poses"])
        assert torch.equal(other["cost"], first["cost"])
        assert other["iters"] == first["iters"]
        assert other["all_reduces"] == first["all_reduces"]
    for ref_p, ref_c in refs:
        assert abs(float(first["cost"]) - float(ref_c)) <= COST_RTOL * abs(float(ref_c)) + 1e-6
        np.testing.assert_allclose(first["poses"].numpy()[:n], np.asarray(ref_p)[:n],
                                   atol=POSE_ATOL)
    # one all-reduce per node-sized sum and per cost
    assert first["all_reduces"] > 2 * first["iters"]
    assert first["host_syncs"] >= first["iters"]


@pytest.fixture(scope="module")
def two_ranks(problems):
    """One spawn of two gloo ranks running every sharded program."""
    _, _, gather_arrays = problems["gather"]
    runs = tmh.launch_local(
        f"{TASKS}:everything_on_two", 2,
        args=([_td(g) for g in problems["graphs"]], BUDGET, problems["chain"][2],
              (problems["gather"][1], _port_gather_operands(gather_arrays)),
              problems["scan"][2]),
        backend="gloo", timeout=SPAWN_TIMEOUT)
    return [r.result for r in runs]


# ---- the SPA hooks ----

@pytest.mark.parametrize("noise,seed", [(0.05, 0), (0.08, 7)])
def test_identity_hooks_leave_the_solve_unchanged(noise, seed):
    """With reduce_fn / scalar_reduce_fn the identity, the solve is the
    hook-free one bit for bit; the hooks see every node-sized sum and every
    cost."""
    td = _td(_make_loop_graph(noise=noise, seed=seed)[0])
    seen = {"nodes": 0, "scalars": 0}

    def nodes(x):
        seen["nodes"] += 1
        assert x.shape[0] == td.poses.shape[0]
        return x

    def scalars(x):
        seen["scalars"] += 1
        assert x.dim() == 0
        return x

    want = tspa.lm_solve(td)
    got = tspa.lm_solve(td, reduce_fn=nodes, scalar_reduce_fn=scalars)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    # per LM iteration: the gradient, the block diagonal and one product per
    # CG step; the first cost and one per iteration
    assert seen["scalars"] == want[2] + 1
    assert seen["nodes"] > 2 * want[2]


@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 7])
def test_pad_edges_to_equals_jax(multiple):
    arrays = _make_loop_graph(n=20, pad_n=20, pad_e=21)[0]
    jd, td = _both(arrays)
    want = jdist.pad_edges_to(jd, multiple)
    got = tdist.pad_edges_to(td, multiple)
    assert got.edge_ij.shape[0] % multiple == 0
    for name in tspa.PoseGraphData._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


# ---- the sharded SPA ----

@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_spa_equals_single_and_jax(world, problems, single_solves, request):
    """Edges split over W gloo ranks, padded and unpadded graphs (uneven
    shards): the ranks agree bit for bit (every loop test reads all-reduced
    values), and each solve equals the port's single solve and JAX
    ``solve_pose_graph`` at the same iterations to the bars of
    tests/test_parallel.py."""
    graphs = problems["graphs"]
    if world == 2:
        ranks = [r["spa"] for r in request.getfixturevalue("two_ranks")]
    else:
        ranks = [r.result for r in tmh.launch_local(
            f"{TASKS}:sharded_spa", world, args=([_td(g) for g in graphs], *BUDGET),
            backend="gloo", timeout=SPAWN_TIMEOUT)]
    for k, arrays in enumerate(graphs):
        _check_sharded([r[k] for r in ranks], single_solves[k, BUDGET],
                       int(arrays["node_mask"].sum()))


def test_sharded_spa_full_budget_equals_single_and_jax(problems, single_solves, two_ranks):
    """tests/test_parallel.py:17-24 as it stands: the default 50 LM / 100 CG
    iterations, over two ranks."""
    _check_sharded([r["spa_full"] for r in two_ranks], single_solves[0, (50, 100)],
                   int(problems["graphs"][0]["node_mask"].sum()))


# ---- the sharded matchers ----

def test_batched_chain_matcher_equals_jax(problems, two_ranks):
    """Rows with their own centres, as tests/test_multiprocess.py runs them:
    the port unsharded and over two ranks against the JAX vmap (bar 1e-4,
    that test's)."""
    jax_args, arrays, (port_args, operands) = problems["chain"]
    jp, js, jc = jsm.make_batched_chain_matcher(*jax_args)(*[jnp.asarray(a) for a in arrays])
    single = tsm.make_batched_chain_matcher(*port_args)(*operands)
    sharded = [r["chain"] for r in two_ranks]
    for got in (single, *sharded):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jp), atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(js), atol=1e-4)
        assert got[2].shape == jc.shape
    for a, b in zip(*sharded):
        assert torch.equal(a, b)


def test_sharded_chain_matcher_gather_equals_jax(problems, two_ranks):
    """B=8 chains over two ranks, four each, against JAX
    ``chain_match_batch_gather`` at the bars of
    tests/test_torch_matchers_frontend.py:261-263 (pose 5e-6, score 2e-5)."""
    import roborts_slam_tpu.backend.processor as jbp

    jb, tb, a = problems["gather"]
    want = jbp.chain_match_batch_gather(
        jb, jnp.asarray(a["all_pts"]), jnp.asarray(a["all_msk"]), jnp.asarray(a["all_nv"]),
        jnp.asarray(a["all_poses"]), jnp.asarray(a["ids"].astype(np.int32)), jnp.int32(1),
        jnp.asarray(a["inits"]), jnp.asarray(a["center"]), jnp.asarray(a["hits"]),
        jnp.asarray(a["passes"]), jnp.asarray(a["pub_off"]))
    single = tsm.make_sharded_chain_matcher_gather(tb, None)(*_port_gather_operands(a))
    sharded = [r["gather"] for r in two_ranks]
    for got in (single, *sharded):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
        np.testing.assert_allclose(got[2].numpy()[:, :2, :2], np.asarray(want[2])[:, :2, :2],
                                   rtol=1e-3, atol=1e-9)
    for a_, b_ in zip(*sharded):
        assert torch.equal(a_, b_)
    # the rows gathered through the all-reduce keep the bits each rank
    # computed for its own block
    for rank, got in enumerate(two_ranks):
        own = slice(4 * rank, 4 * rank + 4)
        for g, local in zip(got["gather"], got["gather_own_block"]):
            assert torch.equal(g[own], local)


def test_batched_scan_matcher_equals_jax(problems, two_ranks):
    """Eight perturbed starts of one scan against one map pyramid
    (tests/test_parallel.py:27-79), against JAX
    ``make_batched_scan_matcher(mesh=None)``: poses within 5e-6, scores
    within 2e-5 (the chain bars: the same three tiers); all recover the pose
    as that test asks."""
    jax_args, operands, (port_args, t_operands) = problems["scan"]
    jp, js, _ = jsm.make_batched_scan_matcher(*jax_args)(*[jnp.asarray(a) for a in operands])
    single = tsm.make_batched_scan_matcher(*port_args)(*t_operands)
    sharded = [r["scan"] for r in two_ranks]
    for got in (single, *sharded):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jp), atol=5e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(js), atol=2e-5)
        assert np.all(got[1].numpy() > 0.5) and np.abs(got[0].numpy()[:, :2]).max() < 0.03
    for a, b in zip(*sharded):
        assert torch.equal(a, b)
    # three matchers, one gather each
    assert two_ranks[0]["data_all_reduces"] == 3


def test_batch_not_a_multiple_of_the_axis_raises():
    mesh = tmesh.Mesh(axis_names=("data",), shape={"data": 3}, device=torch.device("cpu"),
                      groups={"data": None}, index={"data": 0})
    with pytest.raises(ValueError, match="multiple"):
        tsm._block(mesh, "data", 8)
    with pytest.raises(ValueError, match="multiple"):
        tmesh.shard_batch(mesh, torch.zeros(8, 2))


# ---- mesh helpers and the harness ----

def test_single_process_mesh_and_helpers():
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.is_member and mesh.size == 1
    x = torch.arange(12.0).reshape(6, 2)
    tree = {"a": x, "b": (x[:, 0], 3)}
    assert torch.equal(tmesh.shard_batch(mesh, tree)["a"], x)
    assert tmesh.replicate(mesh, tree)["b"][1] == 3
    assert mesh.all_reduce(x, "data") is x and mesh.all_reduces == 0
    m2 = tmesh.make_mesh_2d(1, 1, device="cpu")
    assert m2.axis_names == ("data", "graph")
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device="cpu")
    for shape, axis, multiple in (((5, 3), 0, 4), ((5, 3), 1, 2), ((8,), 0, 4)):
        a = np.arange(int(np.prod(shape))).reshape(shape)
        np.testing.assert_array_equal(tmesh.pad_to_multiple(a, multiple, axis, fill=-1),
                                      jmesh.pad_to_multiple(a, multiple, axis, fill=-1))


def test_synthetic_loop_graph_equals_jax():
    for n, seed in ((64, 0), (96, 3)):
        want = jmh.make_synthetic_loop_graph(n, seed=seed)
        got = tmh.make_synthetic_loop_graph(n, seed=seed, device="cpu")
        for name in tspa.PoseGraphData._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)


def test_harness_mechanics(two_ranks):
    """Shaped like tests/test_parallel.py:82-95, over two ranks: the global
    mesh covers the world, ``scaling_run`` measures sizes 1 and 2 on rank 0
    (rank 1 sits out size 1), throughput positive, size 1 the baseline.
    Mechanics only: two ranks share this host's cores."""
    names, shape, index = two_ranks[0]["global_mesh"]
    assert names == ("data", "graph") and shape["data"] * shape["graph"] == 2
    assert two_ranks[1]["global_mesh"][2] != index
    p0, p1 = two_ranks[0]["points"], two_ranks[1]["points"]
    assert [p[0] for p in p0] == [1, 2] and [p[0] for p in p1] == [2]
    assert all(p[2] > 0 for p in p0) and p0[0][3] == 1.0
    # one process: the 1x1 mesh and size 1
    wf = tmh.spa_scaling_workload(n_nodes=64, max_iters=3, cg_iters=5)
    pts = tmh.scaling_run(wf, [1], reps=1, device="cpu")
    assert tmh.global_mesh(device="cpu").shape == {"data": 1, "graph": 1}
    assert len(pts) == 1 and pts[0].throughput > 0 and pts[0].efficiency == 1.0


def test_initialize_distributed_single_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_default_backend_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend is NCCL there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.initialize_distributed("127.0.0.1:29999", 1, 0)
    assert not torch.distributed.is_initialized()


def test_launcher_ends_failing_and_hanging_ranks():
    """A rank that raises fails the launch with its traceback; ranks that
    hang are ended at the launcher's timeout."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmh.launch_local(f"{TASKS}:fail_on_rank_1", 2, backend="gloo",
                         timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="still running"):
        tmh.launch_local(f"{TASKS}:hang_on_rank_0", 2, backend="gloo", timeout=8.0)
