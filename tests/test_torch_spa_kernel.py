"""The SPA solve's CG kernel (``ops/cuda/spa_pcg.cu``) on the card, against
the masked PyTorch ``_pcg`` on the card and the JAX package's solve
(``tests/data/spa_kernel_jax.npz``, written on the CPU by
``scripts/torch_spa_kernel_fixture.py``: this file imports no JAX). Every
test needs a CUDA device and ``nvcc`` and skips without them. On the card,
from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spa_kernel.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)"""

import numpy as np
import pytest
import torch

import roborts_slam_tpu_torch.backend.spa as tspa
from roborts_slam_tpu_torch.ops.cuda import build, spa_pcg
from _torch_spa_graphs import FIELDS, FIXTURE, FIXTURE_GRAPHS, loop_graph

pytestmark = pytest.mark.card

BUCKETS = [(bn, pe) for bn in (64, 512, 2048, 8192) for pe in (bn, 2 * bn)]


@pytest.fixture
def card():
    """The card, or a skip where there is none or no ``nvcc``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    try:
        build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda", 0)


def _data(arrays: dict, dev) -> tspa.PoseGraphData:
    return tspa.PoseGraphData(**{f: torch.as_tensor(arrays[f], device=dev) for f in FIELDS})


def _system(bn, pe, seed, dev):
    """The first LM iteration's CG inputs of a loop graph on the card: the
    linearization, b = -g, the damping and the preconditioner blocks."""
    data = _data(loop_graph(bn, pe, seed), dev)
    gauge = tspa._gauge_mask(data)
    lin = tspa._linearize(data.poses, data, gauge)
    b = -tspa._gradient(lin, data.poses, data)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    return data, lin, b, lam, tspa._preconditioner(lin, data, lam).contiguous()


def _kernel(data, lin, b, lam, pinv, done=False, iters=100):
    ptr, entries = spa_pcg.incidence(data.edge_ij, data.poses.shape[0])
    flag = torch.full((), done, dtype=torch.bool, device=b.device)
    return spa_pcg.pcg(lin.ja, lin.jb, lin.info, lin.gauge, pinv, b, lam, flag,
                       data.edge_ij, ptr, entries, iters, 1e-6)


def _residuals(data, lin, b, lam, pinv, iters=100, tol=1e-6):
    """‖r‖ before each step of the masked loop's arithmetic (host loop on the
    card, the masked ``_hvp``), and the test's threshold."""
    def precond(v):
        return torch.einsum("nij,nj->ni", pinv, v) * lin.gauge

    r, z = b, precond(b)
    p, rz = z, torch.sum(b * z)
    thr = float(tol * torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-12))
    out = []
    for _ in range(iters + 1):
        out.append(float(torch.sqrt(torch.sum(r * r))))
        hp = tspa._hvp(lin, data, p) + lam * (p * lin.gauge)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp(rz, min=1e-20) * p
        rz = rz_new
    return out, thr


def _masked_f64(data, lin, b, lam, steps: int):
    """The masked loop in float64 on the card, on the same inputs, for
    exactly ``steps`` steps (test threshold 0)."""
    d64 = data._replace(poses=data.poses.double(), edge_rel=data.edge_rel.double(),
                        edge_info=data.edge_info.double())
    lin64 = tspa._Linearization(*(t.double() for t in lin))
    return tspa._pcg(lin64, d64, b.double(), lam.double(), steps, 0.0)[0]


@pytest.mark.parametrize("bn,pe", BUCKETS)
def test_kernel_matches_masked_pcg(card, bn, pe):
    """One CG call at node buckets 64 to 8192, edges bn and 2·bn: the same
    steps as the masked loop on the card, unless the masked loop's ‖r‖ at
    the first step where they part lies within 1e-4 of the test's threshold;
    x within 1e-5 of ‖x‖ of the masked loop's run in float64 for as many
    steps. (Against the float32 masked loop itself the bar sits at that
    loop's own noise on a chain-like graph: on an H100 at 64 × 64 its
    atomic and deterministic sums part by 5.3e-6 of ‖x‖ and lie 5.8e-6 and
    1.1e-5 from float64, the kernel 2.0e-6.)"""
    data, lin, b, lam, pinv = _system(bn, pe, bn + pe, card)
    _, want_steps = tspa._pcg(lin, data, b, lam, 100, 1e-6)
    got, got_steps = _kernel(data, lin, b, lam, pinv)
    ks, ms = int(got_steps), int(want_steps)
    want = _masked_f64(data, lin, b, lam, ks)
    scale = float(torch.linalg.vector_norm(want))
    gap = float((got.double() - want).abs().max())
    assert gap <= 1e-5 * scale, (gap, scale, ks, ms)
    if ks != ms:
        norms, thr = _residuals(data, lin, b, lam, pinv)
        k = min(ks, ms)
        assert abs(norms[k] - thr) <= 1e-4 * thr, (ks, ms, norms[k], thr)


def test_kernel_done_takes_no_step(card):
    """With the LM carry's ``done`` set: zero steps and x = 0."""
    data, lin, b, lam, pinv = _system(512, 1024, 3, card)
    x, steps = _kernel(data, lin, b, lam, pinv, done=True)
    assert int(steps) == 0 and not bool(x.any())


@pytest.mark.parametrize("bn,pe", [(512, 1024), (2048, 4096), (8192, 16384)])
def test_kernel_repeats_its_bits(card, bn, pe):
    """Fixed-order sums and no atomics: two launches, the same bits."""
    data, lin, b, lam, pinv = _system(bn, pe, 11, card)
    first = _kernel(data, lin, b, lam, pinv)
    second = _kernel(data, lin, b, lam, pinv)
    assert torch.equal(first[0], second[0]) and int(first[1]) == int(second[1])


@pytest.mark.parametrize("k", range(len(FIXTURE_GRAPHS)))
def test_solve_program_matches_jax(card, k):
    """The full ``lm_solve`` through the bucket's ``SolveProgram`` (the CG
    kernel in its captured iteration) against JAX's ``solve_pose_graph`` of
    the same padded graph: positions and angles within 1e-4, the cost
    within 1e-5 relative; a second solve replays the program."""
    fx = np.load(FIXTURE)
    data = _data({f: fx[f"g{k}_{f}"] for f in FIELDS}, card)
    tspa._programs.pop(tspa.program_key(data), None)
    for call in ("capture", "replay"):
        before = spa_pcg.pcg_launches
        packed, prog = tspa.solve_packed(data)
        poses, cost, _ = (t.cpu() for t in tspa._unpacked(packed))
        assert prog.last == call
        assert spa_pcg.pcg_launches - before == 50
        n = int(fx[f"g{k}_node_mask"].sum())
        want = fx[f"g{k}_jax_poses"][:n]
        got = poses.numpy()[:n]
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
        d = np.arctan2(np.sin(got[:, 2] - want[:, 2]), np.cos(got[:, 2] - want[:, 2]))
        assert np.abs(d).max() <= 1e-4
        jc = float(fx[f"g{k}_jax_cost"])
        assert abs(float(cost) - jc) <= 1e-5 * abs(jc), (float(cost), jc)
