"""Port vs JAX package: the SPA pose-graph solver, on the graphs of
``tests/test_spa.py`` (a noisy circular trajectory with a loop edge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.backend.spa as jspa
import roborts_slam_tpu_torch.backend.spa as tspa
from roborts_slam_tpu.backend.pose_graph import PoseGraph as JGraph
from roborts_slam_tpu_torch.backend.pose_graph import PoseGraph as TGraph


def _make_loop_graph(n=40, noise=0.05, seed=0, pad_n=64, pad_e=128):
    """Ground-truth circular trajectory; odometry edges + one loop edge
    (numpy float64 throughout, then cast to f32 for both solvers)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    wrap = lambda a: np.arctan2(np.sin(a), np.cos(a))
    gt = np.stack([3 * np.cos(t), 3 * np.sin(t), wrap(t + np.pi / 2)], -1)
    edges, rels, infos = [], [], []

    def add_edge(i, j, sigma):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        dx, dy = gt[j, 0] - gt[i, 0], gt[j, 1] - gt[i, 1]
        rel = np.array([c * dx + s * dy, -s * dx + c * dy, wrap(gt[j, 2] - gt[i, 2])])
        edges.append((i, j))
        rels.append(rel + rng.normal(0, sigma, 3) * [1, 1, 0.3])
        infos.append(np.eye(3) / max(sigma, 1e-3) ** 2)

    for i in range(n - 1):
        add_edge(i, i + 1, noise)
    add_edge(n - 1, 0, noise * 0.1)
    add_edge(0, n // 2, noise * 0.2)
    init = np.zeros((n, 3))
    init[0] = gt[0]
    for k in range(n - 1):
        i, j = edges[k]
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[j] = [init[i, 0] + c * rels[k][0] - s * rels[k][1],
                   init[i, 1] + s * rels[k][0] + c * rels[k][1],
                   init[i, 2] + rels[k][2]]
    E = len(edges)
    arrays = dict(
        poses=np.zeros((pad_n, 3), np.float32), node_mask=np.zeros(pad_n, bool),
        edge_ij=np.zeros((pad_e, 2), np.int32), edge_rel=np.zeros((pad_e, 3), np.float32),
        edge_info=np.tile(np.eye(3, dtype=np.float32), (pad_e, 1, 1)),
        edge_mask=np.zeros(pad_e, bool))
    arrays["poses"][:n] = init
    arrays["node_mask"][:n] = True
    arrays["edge_ij"][:E] = edges
    arrays["edge_rel"][:E] = rels
    arrays["edge_info"][:E] = infos
    arrays["edge_mask"][:E] = True
    return arrays, gt, n


def _both(arrays):
    jd = jspa.PoseGraphData(**{k: jnp.asarray(v) for k, v in arrays.items()})
    td = tspa.PoseGraphData(**{
        k: torch.as_tensor(v.astype(np.int64) if k == "edge_ij" else v)
        for k, v in arrays.items()})
    return jd, td


@pytest.mark.parametrize("noise,seed", [(0.05, 0), (0.05, 3), (0.08, 7), (0.0, 1)])
def test_residuals_jacobians_cost_equal(noise, seed):
    arrays, gt, n = _make_loop_graph(noise=noise, seed=seed)
    jd, td = _both(arrays)
    # residuals are O(1) values of f32 trigonometry; the cost weights their
    # squares by informations up to 1/sigma^2 = 4e4
    np.testing.assert_allclose(tspa.edge_residuals(td.poses, td).numpy(),
                               np.asarray(jspa.edge_residuals(jd.poses, jd)), atol=2e-6)
    for t, j in zip(tspa.edge_jacobians(td.poses, td), jspa.edge_jacobians(jd.poses, jd)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6)
    cj, ct = float(jspa.graph_cost(jd.poses, jd)), float(tspa.graph_cost(td.poses, td))
    assert abs(cj - ct) <= 1e-5 * abs(cj) + 1e-6


@pytest.mark.parametrize("noise,seed", [(0.05, 0), (0.05, 3), (0.08, 7)])
def test_solver_matches_jax(noise, seed):
    arrays, gt, n = _make_loop_graph(noise=noise, seed=seed)
    jd, td = _both(arrays)
    jp, jc, jit_ = jspa.solve_pose_graph(jd)
    before = tspa.host_syncs
    tp, tc, tit = tspa.solve_pose_graph(td)
    assert tspa.host_syncs > before          # loop conditions are host reads
    # both run the same LM/PCG iteration in f32; sums are taken in another
    # order, and the solution sits in a flat valley of the cost: final poses
    # within 1e-4 m, cost within 1e-5 relative
    np.testing.assert_allclose(tp.numpy()[:n], np.asarray(jp)[:n], atol=1e-4)
    assert abs(float(tc) - float(jc)) <= 1e-5 * float(jc)
    err = np.linalg.norm(tp.numpy()[:n, :2] - gt[:, :2], axis=1)
    assert err.mean() < 4 * noise          # and it is a solution: near ground truth
    assert 1 <= tit <= 50


def test_solver_improves_loop_error_unpadded():
    arrays, gt, n = _make_loop_graph(noise=0.08, seed=7, pad_n=40, pad_e=41)
    _, td = _both(arrays)
    gap0 = np.linalg.norm(arrays["poses"][n - 1, :2] - gt[-1, :2])
    poses, cost, _ = tspa.solve_pose_graph(td)
    gap1 = np.linalg.norm(poses.numpy()[n - 1, :2] - gt[-1, :2])
    assert gap1 < gap0 * 0.5
    assert float(cost) < float(tspa.graph_cost(td.poses, td)) * 0.1


def test_pose_graph_host_logic_equal():
    """The host-side graph copy: same edges, chains and solver data."""
    rng = np.random.default_rng(5)
    jg, tg = JGraph(3.0, 3), TGraph(3.0, 3)
    n = 30
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    poses = np.stack([4 * np.cos(t), 4 * np.sin(t), t], -1)
    bary = poses + rng.normal(0, 0.01, poses.shape)
    cov = np.diag([1e-3, 2e-3, 1e-4])
    for g in (jg, tg):
        for i in range(n):
            g.add_vertex()
            if i:
                assert g.add_edge(i - 1, i, poses[i - 1], poses[i], cov)
        assert not g.add_edge(1, 0, poses[1], poses[0], cov)
    for sid in (n - 1, n // 2):
        assert jg.find_near_linked_scans(sid, bary) == tg.find_near_linked_scans(sid, bary)
        assert jg.find_near_chains(sid, bary) == tg.find_near_chains(sid, bary)
        assert jg.find_all_loop_candidates(sid, bary) == tg.find_all_loop_candidates(sid, bary)
    assert tg.find_all_loop_candidates(n - 1, bary)            # the circle closes
    assert JGraph.sparsify_chain(list(range(25))) == TGraph.sparsify_chain(list(range(25)))
    jd = jg.as_solver_data(poses)                 # padded to 64 nodes / edges
    td = tg.as_solver_data(poses, "cpu")          # unpadded
    assert td.poses.shape == (n, 3) and td.edge_ij.shape == (n - 1, 2)
    assert bool(td.node_mask.all()) and bool(td.edge_mask.all())
    assert int(jd.node_mask.sum()) == n and int(jd.edge_mask.sum()) == n - 1
    for name, rows in (("poses", n), ("edge_ij", n - 1), ("edge_rel", n - 1),
                       ("edge_info", n - 1)):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name))[:rows])
