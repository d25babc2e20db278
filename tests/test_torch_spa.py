"""Port vs JAX package: the SPA pose-graph solver, on the graphs of
``tests/test_spa.py`` (a noisy circular trajectory with a loop edge); and
the port's masked on-device loops against the loop they replaced, which
tested every step on the host (kept here as ``_host_read_lm_solve``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.backend.spa as jspa
import roborts_slam_tpu_torch.backend.spa as tspa
from roborts_slam_tpu.backend.pose_graph import PoseGraph as JGraph
from roborts_slam_tpu_torch.backend.pose_graph import PoseGraph as TGraph
from roborts_slam_tpu_torch.utils.geometry import normalize_angle


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
    assert tspa.host_syncs == before         # no host read inside the solve
    # both run the same LM/PCG iteration in f32; sums are taken in another
    # order, and the solution sits in a flat valley of the cost: final poses
    # within 1e-4 m, cost within 1e-5 relative
    np.testing.assert_allclose(tp.numpy()[:n], np.asarray(jp)[:n], atol=1e-4)
    assert abs(float(tc) - float(jc)) <= 1e-5 * float(jc)
    err = np.linalg.norm(tp.numpy()[:n, :2] - gt[:, :2], axis=1)
    assert err.mean() < 4 * noise          # and it is a solution: near ground truth
    assert 1 <= tit <= 50


# ---- the loop before the masked one: a host read per CG step and per LM
# iteration, the Jacobians recomputed in every product ----

def _gauge_project(x, node_mask):
    m = node_mask.to(x.dtype)[:, None].clone()
    m[0] = 0.0
    return x * m


def _segment_sum(like, data, ga, gb):
    out = torch.zeros_like(like)
    out.index_add_(0, data.edge_ij[:, 0], ga)
    out.index_add_(0, data.edge_ij[:, 1], gb)
    return out


def _hvp(poses, data, x):
    ja, jb = tspa.edge_jacobians(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None, None]
    xa = x[data.edge_ij[:, 0]]
    xb = x[data.edge_ij[:, 1]]
    jx = (torch.einsum("eij,ej->ei", ja, xa) + torch.einsum("eij,ej->ei", jb, xb))
    ijx = torch.einsum("eij,ej->ei", data.edge_info * w, jx)
    ga = torch.einsum("eji,ej->ei", ja, ijx)
    gb = torch.einsum("eji,ej->ei", jb, ijx)
    return _gauge_project(_segment_sum(x, data, ga, gb), data.node_mask)


def _gradient(poses, data):
    r = tspa.edge_residuals(poses, data)
    ja, jb = tspa.edge_jacobians(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None]
    ir = torch.einsum("eij,ej->ei", data.edge_info, r) * w
    ga = torch.einsum("eji,ej->ei", ja, ir)
    gb = torch.einsum("eji,ej->ei", jb, ir)
    return _gauge_project(_segment_sum(poses, data, ga, gb), data.node_mask)


def _block_diag(poses, data, damping):
    ja, jb = tspa.edge_jacobians(poses, data)
    w = data.edge_mask.to(poses.dtype)[:, None, None]
    info = data.edge_info * w
    ba = torch.einsum("eki,ekl,elj->eij", ja, info, ja)
    bb = torch.einsum("eki,ekl,elj->eij", jb, info, jb)
    blocks = torch.zeros((poses.shape[0], 3, 3), dtype=poses.dtype)
    blocks = _segment_sum(blocks, data, ba, bb)
    return blocks + (damping + 1e-6) * torch.eye(3, dtype=poses.dtype)[None]


def _pcg(poses, data, b, damping, iters, tol):
    pinv = torch.linalg.inv(_block_diag(poses, data, damping))

    def precond(v):
        return _gauge_project(torch.einsum("nij,nj->ni", pinv, v), data.node_mask)

    def matvec(v):
        return _hvp(poses, data, v) + damping * _gauge_project(v, data.node_mask)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12)
    i = 0
    while i < iters and bool(torch.sqrt(torch.sum(r * r)) > tol * bnorm):
        hp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
        i += 1
    return x


def _host_read_lm_solve(data, max_iters=50, cg_iters=100):
    poses = data.poses
    lam = torch.as_tensor(1e-4, dtype=poses.dtype)
    cost = tspa.graph_cost(poses, data)
    it = 0
    done = False
    while it < max_iters and not done:
        g = _gradient(poses, data)
        step = _pcg(poses, data, -g, lam, cg_iters, 1e-6)
        new_poses = poses + step
        new_poses = torch.cat(
            [new_poses[:, :2], normalize_angle(new_poses[:, 2:3])], dim=1)
        new_cost = tspa.graph_cost(new_poses, data)
        improved = new_cost < cost
        poses = torch.where(improved, new_poses, poses)
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-8), lam * 10.0)
        gnorm = torch.sqrt(torch.sum(g * g))
        converged = improved & ((cost - new_cost) < 1e-7 * (cost + 1e-12))
        converged = converged | (gnorm < 1e-10)
        cost = torch.where(improved, new_cost, cost)
        it += 1
        done = bool(converged)
    return poses, cost, it


@pytest.mark.parametrize("budget", [(50, 100), (6, 4)])
@pytest.mark.parametrize("noise,seed", [(0.05, 0), (0.05, 3), (0.08, 7)])
def test_masked_solve_equals_the_host_read_loop(noise, seed, budget, monkeypatch):
    """The fixed masked loops with the Jacobians computed once per LM
    iteration give the host-read loop's poses, cost and iteration count bit
    for bit, on the graphs of ``test_solver_matches_jax``, at the full
    budget and at one that the loops exhaust; and read nothing on the
    host."""
    arrays, _, _ = _make_loop_graph(noise=noise, seed=seed)
    _, td = _both(arrays)
    reads = []
    monkeypatch.setattr(tspa, "_read", lambda x: reads.append(x) or float(x))
    before = tspa.host_syncs
    tp, tc, tit = tspa.lm_solve(td, *budget)
    assert reads == [] and tspa.host_syncs == before
    wp, wc, wit = _host_read_lm_solve(td, *budget)
    assert torch.equal(tp, wp) and torch.equal(tc, wc)
    assert tit.dtype == torch.int32 and int(tit) == wit
    assert budget[0] > 6 or wit == 6        # the short budget ran out


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
    jd = jg.as_solver_data(poses)                 # both padded to 64 nodes / edges
    td = tg.as_solver_data(poses, "cpu")
    assert td.poses.shape == (64, 3) and td.edge_ij.shape == (64, 2)
    assert int(jd.node_mask.sum()) == n and int(jd.edge_mask.sum()) == n - 1
    for name in tspa.PoseGraphData._fields:
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
