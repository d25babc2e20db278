"""The roundings of the JAX package's compiled step that the port mirrors
(``roborts_slam_tpu_torch/ops/xla_rounding.py``): each helper held bit for
bit against ``jax.jit`` of the JAX expression it mirrors, on 10^4 seeded
inputs at the tiers' shapes and the maps' resolutions; the angle ramp and
the fine tier's candidate offsets, which XLA rounds otherwise when jitted
alone than inside the step, against the step's own outputs through the
lockstep tap. And the one f32
fused multiply-add they rest on, against exact rational arithmetic."""

import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
from roborts_slam_tpu.models import grid_map as jgm
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu.ops import correlative as jc
from roborts_slam_tpu_torch.models import grid_map as tgm
from roborts_slam_tpu_torch.ops import correlative as tc
from roborts_slam_tpu_torch.ops import xla_rounding as X
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
N = 10_000
TIERS = [(101, 9, 9), (21, 11, 11), (21, 3, 3)]    # coarse, fine, super-fine (every profile)
RESOLUTIONS = [0.01, 0.02, 0.025, 0.05, 0.1]       # fine maps, the pub map, the coarse map


def _f32_round(x: Fraction) -> np.float32:
    """The f32 nearest ``x`` (ties to even), from exact arithmetic."""
    r = np.float32(float(x))
    cands = [r, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    near = [c for c, d in zip(cands, dist) if d == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once_but_at_halfway_sums():
    """``fma_f32`` equals the exactly rounded a * b + c on 2000 seeded
    triples over six decades; it rounds twice (float64, then f32) and so
    differs from one f32 fused multiply-add only where the float64 sum is
    inexact and lands exactly halfway between two f32: a * b = 1 + 2^-24
    exactly (the midpoint of two f32), c = 2^-80. There the float64 sum
    drops c and the f32 rounding ties to even, 1.0, where one rounding
    gives 1 + 2^-23. The same float64 operations run on the card
    (``chip_smoke.py``'s ``kernel_vs_plain_lockstep`` compares the bits)."""
    rng = np.random.default_rng(11)
    a, b, c = (rng.standard_normal(2000).astype(np.float32) * 10 ** rng.integers(-3, 4, 2000)
               .astype(np.float32) for _ in range(3))
    got = X.fma_f32(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = np.array([_f32_round(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
                     for p, q, r in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    a, b, c = (torch.tensor([v], dtype=torch.float32)
               for v in (97 * 257 * 2.0 ** -14, 673 * 2.0 ** -10, 2.0 ** -80))
    assert float(a * b) != 1 + 2.0 ** -24 and a.double() * b.double() == 1 + 2.0 ** -24
    exact = _f32_round(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
    assert float(exact) == 1 + 2.0 ** -23 and float(X.fma_f32(a, b, c)) == 1.0


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_map_to_world_pose_matches_jit(res):
    """``map_to_world_pose`` (through ``map_to_world_xy``) equals JAX's
    ``map_to_world_pose`` under ``jax.jit`` (``inv_res`` static, as in the
    step) bit for bit on 10^4 poses over a 4096-cell map; the source's
    division, as JAX runs it op by op, differs on most of them."""
    rng = np.random.default_rng(int(res * 1000))
    inv = 1.0 / res
    pose = np.stack([rng.uniform(0, 4096, N), rng.uniform(0, 4096, N),
                     rng.uniform(-np.pi, np.pi, N)], 1).astype(np.float32)
    off = rng.uniform(0, 4096 * res, (N, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda o, p: jgm.map_to_world_pose(o, inv, p))(off, pose))
    got = tgm.map_to_world_pose(torch.as_tensor(off), inv, torch.as_tensor(pose)).numpy()
    np.testing.assert_array_equal(got, want)
    source = pose[:, :2] / np.float32(inv) - off
    assert (source != want[:, :2]).mean() > 0.2


def _tie_grids(shape, seed):
    """N / 4 penalized score grids of ``shape`` with 1 to ``TIE_SLOTS``
    candidates within 0.01 of the best (the tie set), angles and candidate
    coordinates."""
    rng = np.random.default_rng(seed)
    A, Nx, Ny = shape
    n_grids = N // 4
    s = rng.uniform(0.2, 0.7, (n_grids, A * Nx * Ny)).astype(np.float32)
    for k, n in enumerate(rng.integers(1, X.TIE_SLOTS + 1, n_grids)):
        idx = rng.choice(A * Nx * Ny, n, replace=False)
        s[k, idx] = np.float32(0.9) - rng.uniform(0, 0.0099, n).astype(np.float32)
        s[k, idx[0]] = np.float32(0.9)
    ang = (rng.uniform(-3, 3, (n_grids, 1)) + np.arange(A) * 0.0349).astype(np.float32)
    xs = (rng.uniform(100, 900, (n_grids, 1)) + np.arange(Nx) * 2.5).astype(np.float32)
    ys = (rng.uniform(100, 900, (n_grids, 1)) + np.arange(Ny) * 2.5).astype(np.float32)
    return s.reshape(n_grids, *shape), ang, xs, ys


@pytest.mark.parametrize("shape", TIERS, ids=["coarse", "fine", "super_fine"])
def test_tie_sums_match_jit(shape):
    """The tie average's sums (``tie_sums``: the coarse grid's 101 angles
    summed in XLA's windows of 32, the others in one fused sequential sum)
    equal ``jax.jit`` of JAX's sums in ``find_best_candidate`` bit for bit
    on 10^4 grids, given the same cosines and sines; the averaged x and y
    of ``find_best_candidate`` equal JAX's jitted ones. (Its angle differs
    where torch's and XLA's cos, sin and atan2 differ in the last bit: not
    one of the three roundings.)"""
    def sums(scores, angles, xs, ys):      # JAX find_best_candidate's sums
        best = jnp.max(scores)
        w = (scores >= best - jc.K_RESPONSE_FILTER_TOLERANCE).astype(scores.dtype) * scores
        return jnp.stack([jnp.sum(w), jnp.sum(w * xs[None, :, None]),
                          jnp.sum(w * ys[None, None, :]),
                          jnp.sum(w * jnp.cos(angles)[:, None, None]),
                          jnp.sum(w * jnp.sin(angles)[:, None, None])])

    jsums, jbest = jax.jit(jax.vmap(sums)), jax.jit(jax.vmap(jc.find_best_candidate))
    cos, sin = jax.jit(jnp.cos), jax.jit(jnp.sin)
    t = lambda a: torch.tensor(np.asarray(a))
    for part in range(4):                  # 2500 grids at a time
        s, ang, xs, ys = _tie_grids(shape, seed=shape[0] * 100 + shape[1] + part)
        best = t(s).amax(dim=(1, 2, 3))
        w = (t(s) >= best[:, None, None, None] - tc.K_RESPONSE_FILTER_TOLERANCE).float() * t(s)
        got = X.tie_sums(w, t(xs), t(ys), t(cos(ang)), t(sin(ang)))
        np.testing.assert_array_equal(got.numpy().T, np.asarray(jsums(s, ang, xs, ys)))
        pose_t = tc.find_best_candidate(t(s), t(ang), t(xs), t(ys))[0].numpy()
        np.testing.assert_array_equal(pose_t[:, :2], np.asarray(jbest(s, ang, xs, ys)[0])[:, :2])


def test_tie_sums_past_the_slots_take_the_plain_sums():
    """More tied candidates than ``TIE_SLOTS``: the plain sums; one: its
    products."""
    w = torch.zeros(2, 21, 3, 3)
    w.view(2, -1)[0, :20] = torch.linspace(0.89, 0.9, 20)
    w.view(2, -1)[1, 5] = 0.9                          # angle 0, x 1, y 2
    g = torch.Generator().manual_seed(0)
    xs, ys, c, s = torch.rand(2, 3, generator=g), torch.rand(2, 3, generator=g), \
        torch.rand(2, 21, generator=g), torch.rand(2, 21, generator=g)
    got = X.tie_sums(w, xs, ys, c, s)                  # (sums, batch)
    dims = (-3, -2, -1)
    plain = torch.stack([w.sum(dims), (w * xs[:, None, :, None]).sum(dims),
                         (w * ys[:, None, None, :]).sum(dims), (w * c[:, :, None, None]).sum(dims),
                         (w * s[:, :, None, None]).sum(dims)])
    assert torch.equal(got[:, 0], plain[:, 0])         # 20 ties: the plain sums
    assert torch.equal(got[:, 1], torch.stack([w[1, 0, 1, 2], w[1, 0, 1, 2] * xs[1, 1],
                                               w[1, 0, 1, 2] * ys[1, 2], w[1, 0, 1, 2] * c[1, 0],
                                               w[1, 0, 1, 2] * s[1, 0]]))


def test_angle_ramp_mirrors_the_compiled_step():
    """The search angles: jitted alone, ``start + arange(A) * step`` rounds
    as its source reads (XLA folds the constant products); inside the step
    the ramp is one fused multiply-add per angle. Held through the lockstep
    tap: from JAX's carried state, over 20 scans of the icra log, the port's
    step gives JAX's pose bit for bit on more steps with ``angle_ramp``
    than with the source's expression in its place."""
    A, step = 101, np.float32(0.0349)
    start = np.random.default_rng(5).uniform(-3.2, 3.2, (N, 1)).astype(np.float32)
    alone = np.asarray(jax.jit(lambda s: s + jnp.arange(A, dtype=jnp.float32) * step)(start))
    np.testing.assert_array_equal(alone, start + np.arange(A, dtype=np.float32) * step)
    fused = X.angle_ramp(torch.as_tensor(start), A, float(step)).numpy()
    assert (fused != alone).any()
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    over = dict(fine_map_resolution=0.02, world_size=24.0)

    def bit_equal_steps():
        je = J.SlamEngine(J.load_config(SIM_YAML, **over), JLaser.from_array(d["laser"]),
                          synchronous_backend=True, fused_backend=False)
        rep = L.lockstep(je, L.scans(d["ranges"][:20], d["odom"][:20], d["times"][:20]),
                         classify=False, fused_backend=False)
        return sum(r.get("pose_gap_m") == 0.0 and r.get("pose_gap_rad") == 0.0
                   for r in rep.rows)

    with_helper = bit_equal_steps()
    source = lambda s, n, st: s + torch.arange(n, dtype=torch.float32, device=s.device) * st
    orig = tc.angle_ramp
    tc.angle_ramp = source
    try:
        with_source = bit_equal_steps()
    finally:
        tc.angle_ramp = orig
    print({"bit_equal_steps_of_20": {"angle_ramp": with_helper, "source": with_source}})
    assert with_helper > with_source and with_helper >= 6


@pytest.mark.parametrize("n", [9, 3], ids=["coarse", "super_fine"])
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_candidate_offsets_match_jit(res, n):
    """A tier's candidate offsets (``candidate_offsets``) equal ``jax.jit``
    of JAX's expression — ``world_to_map_pose``, minus the half-width, plus
    the ramp — bit for bit on 10^4 poses: the centre's product and the
    subtraction one fused multiply-add, each offset one more; JAX run op by
    op differs. (The fine tier's 11 offsets, which the standalone jit
    vectorizes in part as the source reads, are held through the step in
    ``test_candidate_offsets_mirror_the_compiled_step``.)"""
    rng = np.random.default_rng(int(res * 1000) + n)
    inv, size, step_m = 1.0 / res, {9: 0.4, 3: 0.06}[n], {9: 0.05, 3: 0.02}[n]
    pose = np.stack([rng.uniform(-20, 20, N), rng.uniform(-20, 20, N),
                     rng.uniform(-3, 3, N)], 1).astype(np.float32)
    off = rng.uniform(0, 40, (N, 2)).astype(np.float32)
    step, half = step_m * inv, (size * inv) * 0.5

    def source(o, p):                      # JAX score_candidates' xs and ys
        c = jgm.world_to_map_pose(o, inv, p)
        ramp = jnp.arange(n, dtype=jnp.float32) * step
        return jnp.stack([(c[..., 0:1] - half) + ramp, (c[..., 1:2] - half) + ramp], -2)

    want = np.asarray(jax.jit(source)(off, pose))
    got = X.candidate_offsets(torch.as_tensor(pose[:, :2] + off), inv, half, n, step).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.asarray(source(off, pose)) != want).any()


def test_candidate_offsets_mirror_the_compiled_step():
    """Inside the step the fine tier's offsets are ``candidate_offsets``'
    (the fusion maps the centre and forms each offset with fused
    multiply-adds). Held through the lockstep tap: from JAX's carried
    state over the room log under the real-robot profile (a 0.025 m fine
    map, 11 offsets a side), the port's steps stay within every bar and
    give JAX's pose bit for bit on more steps than with the source's
    rounding of the offsets, whose offsets move a sample across a cell
    edge and the covariance beyond its bar."""
    import tempfile

    from tests.test_torch_cli import real_robot_yaml, room_log

    log = room_log()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = J.load_config(real_robot_yaml(os.path.join(tmp, "real_small.yaml")))

    def run():
        je = J.SlamEngine(cfg, JLaser.from_array(log.laser.to_array()), world_size=14.0,
                          synchronous_backend=True, fused_backend=False)
        rep = L.lockstep(je, L.scans(log.ranges, log.odom, log.times), classify=False)
        return rep, sum(r.get("pose_gap_m") == 0.0 and r.get("pose_gap_rad") == 0.0
                        for r in rep.rows)

    helper, with_helper = run()
    orig = tc.candidate_offsets

    def source(center_m, inv_res, half, n, step):
        start = (center_m * np.float32(inv_res) - np.float32(half))[..., None]
        return start + torch.arange(n, dtype=torch.float32) * np.float32(step)

    tc.candidate_offsets = source
    try:
        src, with_source = run()
    finally:
        tc.candidate_offsets = orig
    print({"bit_equal_steps": {"candidate_offsets": with_helper, "source": with_source},
           "failed": {"candidate_offsets": helper.failed(), "source": src.failed()}})
    assert not helper.failed() and with_helper > with_source
