"""Port vs JAX package: rasterization and the map-consistency raycast (hold
kernels K3 and K4's plain versions). Mark images and bad-ray counts are
integer results: they must be EQUAL, against the JAX package's plain-XLA
functions and against its Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.ops.raster as jr
import roborts_slam_tpu.ops.raycast as jrc
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.raster as tr
import roborts_slam_tpu_torch.ops.raycast as trc
from roborts_slam_tpu_torch.ops.cuda.raycarve import bad_ray_count, ray_mark_image


def _scan(seed, n, rmax):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-2.4, 2.4, n)
    r = rng.uniform(0.2, rmax, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = rng.random(n) > 0.1
    return pts, mask


def _count_specs(size=256, window=128):
    kw = dict(resolution=0.05, height=size, width=size, max_ray_cells=52,
              carve_window=window)
    return jgm.CountMapSpec(**kw), tgm.CountMapSpec(**kw)


def _prob_specs(res, size, deviation):
    kw = dict(resolution=res, height=size, width=size, deviation=deviation,
              blur_offset=0.72)
    return jgm.ProbMapSpec(**kw), tgm.ProbMapSpec(**kw)


J = lambda *a: [jnp.asarray(x) for x in a]
T = lambda *a: [torch.as_tensor(np.array(x)) for x in a]

MARK_CASES = [
    (0, [0.0, 0.0, 0.0], 6.4),
    (1, [1.3, -0.7, 0.9], 6.4),
    (2, [-5.0, 5.5, -2.2], 6.4),    # near the map corner
    (3, [0.2, 0.1, 0.0], 0.0),      # sensor at the map origin: rays leave on
                                    # the low side (negative DDA numerators)
    (4, [-0.6, -0.4, 2.0], 0.0),    # sensor itself below/left of the map
]


@pytest.mark.parametrize("seed,pose,offset_m", MARK_CASES)
def test_mark_image_equals_xla(seed, pose, offset_m):
    jspec, tspec = _count_specs()
    pts, mask = _scan(seed, 64, 2.4)
    off = np.array([offset_m] * 2, np.float32)
    pose = np.array(pose, np.float32)
    want = np.asarray(jr.scan_mark_image_xla(jspec, *J(off, pts, mask, pose)))
    got = tr.scan_mark_image(tspec, *T(off, pts, mask, pose)).numpy()
    got_plain = tr.scan_mark_image_plain(tspec, *T(off, pts, mask, pose)).numpy()
    assert int((want != got).sum()) == 0
    assert int((want != got_plain).sum()) == 0
    if offset_m > 0:
        assert (want == 2).sum() > 0 and (want == 1).sum() > 0


@pytest.mark.parametrize("seed,pose,offset_m", MARK_CASES[:4])
def test_mark_image_equals_interpret_mode_pallas(seed, pose, offset_m):
    jspec, tspec = _count_specs()
    pts, mask = _scan(seed, 64, 2.4)
    off = np.array([offset_m] * 2, np.float32)
    pose = np.array(pose, np.float32)
    want = np.asarray(jr.scan_mark_image_pallas(jspec, *J(off, pts, mask, pose),
                                                interpret=True))
    got = tr.scan_mark_image(tspec, *T(off, pts, mask, pose)).numpy()
    assert int((want != got).sum()) == 0


def test_ray_cells_equal():
    jspec, tspec = _count_specs()
    rng = np.random.default_rng(5)
    start = np.array([3, 250], np.int32)
    end = rng.integers(-30, 290, (40, 2)).astype(np.int32)
    bm = rng.random(40) > 0.2
    jf, jm = jr._ray_cells(jspec, *J(start, end, bm))
    tf, tm = tr._ray_cells(tspec, *T(start, end, bm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_mark_wrapper_on_cpu_is_plain_version():
    start = torch.tensor([10, 12], dtype=torch.int32)
    end = torch.tensor([[40, 12], [10, 50], [-5, -7], [10, 12]], dtype=torch.int32)
    bm = torch.tensor([True, True, True, False])
    a = ray_mark_image(start, end, bm, 64, 64)
    b = tr.mark_image_plain(start, end, bm, 64, 64)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a[12, 40]) == 2 and int(a[12, 25]) == 1 and int(a[50, 10]) == 2


@pytest.mark.parametrize("res,size,dev,use_blur", [
    (0.01, 1024, 0.03, True), (0.1, 128, 0.4, True), (0.02, 512, 0.03, False)])
def test_stamp_scan_equal(res, size, dev, use_blur):
    jspec, tspec = _prob_specs(res, size, dev)
    off = np.array([size * res / 2] * 2, np.float32)
    jmap = jgm.make_prob_map(jspec, off)
    tmap = tgm.make_prob_map(tspec, off, "cpu")
    for seed, pose in [(0, [0.1, 0.2, 0.3]), (1, [-0.4, 0.3, -1.0]),
                       (2, [size * res * 0.45, 0.0, 0.5])]:      # clips at the edge
        pts, mask = _scan(seed, 200, 4.0)
        pose = np.array(pose, np.float32)
        jmap = jr.stamp_scan(jspec, jmap, *J(pts, mask, pose), use_blur=use_blur)
        out = tr.stamp_scan(tspec, tmap, *T(pts, mask, pose), use_blur=use_blur)
        assert out.probs is tmap.probs            # in place
        np.testing.assert_array_equal(tmap.probs.numpy(), np.asarray(jmap.probs))
    assert float(tmap.probs.max()) == 1.0


def _chain(seed, k=6, p=128):
    rng = np.random.default_rng(seed)
    pts = np.zeros((k, p, 2), np.float32)
    mask = np.zeros((k, p), bool)
    for i in range(k):
        pi, mi = _scan(seed * 10 + i, p, 2.4)    # <= max_ray_cells of the count specs
        pts[i], mask[i] = pi, mi
    poses = np.concatenate([rng.uniform(-0.5, 0.5, (k, 2)),
                            rng.uniform(-1, 1, (k, 1))], 1).astype(np.float32)
    valid = np.ones(k, bool)
    valid[-1] = False
    return pts, mask, poses, valid


@pytest.mark.parametrize("res,size,dev", [(0.02, 512, 0.03), (0.1, 128, 0.4)])
def test_stamp_scan_batch_equal_and_batched(res, size, dev):
    jspec, tspec = _prob_specs(res, size, dev)
    off = np.array([size * res / 2] * 2, np.float32)
    chains = [_chain(0), _chain(1)]
    singles = []
    for c in chains:
        want = jr.stamp_scan_batch(jspec, jgm.make_prob_map(jspec, off), *J(*c))
        got = tr.stamp_scan_batch(tspec, tgm.make_prob_map(tspec, off, "cpu"), *T(*c))
        np.testing.assert_array_equal(got.probs.numpy(), np.asarray(want.probs))
        singles.append(got.probs)
    # one map per chain along a written-out batch dimension
    probs = torch.full((2, size, size), tspec.default_prob)
    stacked = [torch.as_tensor(np.stack([c[i] for c in chains])) for i in range(4)]
    both = tr.stamp_scan_batch(tspec, tgm.ProbMap(probs, torch.as_tensor(off)), *stacked)
    np.testing.assert_array_equal(both.probs.numpy(), torch.stack(singles).numpy())


def test_dilate_with_kernel_equal():
    rng = np.random.default_rng(3)
    img = (rng.random((40, 50)) > 0.97).astype(np.float32)
    _, tspec = _prob_specs(0.01, 64, 0.03)
    k = tspec.blur_kernel()
    np.testing.assert_array_equal(
        tr.dilate_with_kernel(torch.as_tensor(img), k).numpy(),
        np.asarray(jr.dilate_with_kernel(jnp.asarray(img), k)))


def test_update_and_rebuild_count_map_equal():
    jspec, tspec = _count_specs(window=0)
    off = np.array([6.4, 6.4], np.float32)
    pts, mask, poses, valid = _chain(2, k=5, p=96)
    jmap = jgm.make_count_map(jspec, off)
    tmap = tgm.make_count_map(tspec, off, "cpu")
    for i in range(3):
        jmap = jr.update_count_map(jspec, jmap, *J(pts[i], mask[i], poses[i]), 0.3, 0.7)
        tr.update_count_map(tspec, tmap, *T(pts[i], mask[i], poses[i]), 0.3, 0.7)
    np.testing.assert_array_equal(tmap.hits.numpy(), np.asarray(jmap.hits))
    np.testing.assert_array_equal(tmap.passes.numpy(), np.asarray(jmap.passes))
    want = jr.rebuild_count_map(jspec, jnp.asarray(off), *J(pts, mask, poses, valid),
                                0.3, 0.7, first_scan_extra=3)
    got = tr.rebuild_count_map(tspec, torch.as_tensor(off), *T(pts, mask, poses, valid),
                               0.3, 0.7, first_scan_extra=3)
    # sums of the same f32 increments in the same order
    np.testing.assert_array_equal(got.hits.numpy(), np.asarray(want.hits))
    np.testing.assert_array_equal(got.passes.numpy(), np.asarray(want.passes))


def _blob_map(seed):
    rng = np.random.default_rng(seed)
    passes = (rng.random((256, 256)) * 8).astype(np.float32)
    hits = (passes * (rng.random((256, 256)) > 0.7)).astype(np.float32)
    return hits, passes, np.array([6.4, 6.4], np.float32)


PENALTY_POSES = [(0, [0.0, 0.0, 0.0]), (1, [1.1, -0.8, 0.5]), (2, [-4.9, 5.2, 2.0]),
                 (3, [-7.0, -6.6, 0.3])]     # outside the map


@pytest.mark.parametrize("seed,pose", PENALTY_POSES)
def test_bad_ray_counts_and_penalty_equal(seed, pose):
    jspec, tspec = _count_specs()
    hits, passes, off = _blob_map(11)
    jmap = jgm.CountMap(*J(hits, passes, off))
    tmap = tgm.CountMap(*T(hits, passes, off))
    pts, mask = _scan(seed, 80, 2.4)
    pose = np.array(pose, np.float32)

    # the ray set, as map_feedback_penalty builds it in both packages
    from roborts_slam_tpu.utils.geometry import transform_points as jtp
    pose_map = jgm.world_to_map_pose(jmap.offset, jspec.inv_res, jnp.asarray(pose))
    sidx, svalid = jrc._sample_beams(*J(pts, mask), jnp.int32(80), 40)
    tsidx, tsvalid = trc._sample_beams(*T(pts, mask), 80, 40)
    np.testing.assert_array_equal(tsidx.numpy(), np.asarray(sidx))
    np.testing.assert_array_equal(tsvalid.numpy(), np.asarray(svalid))
    end = jr._cell_round(jtp(pose_map, jnp.asarray(pts)[sidx] * jspec.inv_res))
    start = jr._cell_round(pose_map[:2])
    same = (end[:, 0] == start[0]) & (end[:, 1] == start[1])
    end_in = ((end[:, 0] > 0) & (end[:, 0] < 256) & (end[:, 1] > 0) & (end[:, 1] < 256))
    ray_ok = svalid & ~same & end_in
    args = (jspec, jmap, start, end, ray_ok, jnp.float32(3.0), jnp.float32(0.5), 10)
    want_xla = int(jrc._bad_rays_xla(*args))
    want_pallas = int(jrc._bad_rays_pallas(*args, interpret=True))
    targs = (*[t[None] for t in T(start, end, ray_ok)], tmap.hits, tmap.passes,
             3.0, 0.5, 10)
    got = bad_ray_count(*targs)               # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got) == want_xla == want_pallas
    assert torch.equal(got, trc.bad_rays_plain(*targs))

    want = jrc.map_feedback_penalty(jspec, jmap, *J(pts, mask), jnp.int32(80),
                                    jnp.asarray(pose), 40, 3.0, 0.05,
                                    jnp.float32(3.0), jnp.float32(0.5))
    got = trc.map_feedback_penalty(tspec, tmap, *T(pts, mask), 80,
                                   torch.as_tensor(pose), 40, 3.0, 0.05, 3.0, 0.5)
    # an integer count times the gain: one f32 multiply and subtract
    assert abs(float(got) - float(want)) <= 1e-6


def test_penalty_batched_over_poses():
    _, tspec = _count_specs()
    hits, passes, off = _blob_map(12)
    tmap = tgm.CountMap(*T(hits, passes, off))
    pts, mask = _scan(7, 80, 2.4)
    poses = np.array([p for _, p in PENALTY_POSES], np.float32)
    both = trc.map_feedback_penalty(tspec, tmap, *T(pts, mask), 80,
                                    torch.as_tensor(poses), 40, 3.0, 0.05, 3.0, 0.5)
    assert both.shape == (4,)
    for b in range(4):
        one = trc.map_feedback_penalty(tspec, tmap, *T(pts, mask), 80,
                                       torch.as_tensor(poses[b]), 40, 3.0, 0.05, 3.0, 0.5)
        assert float(one) == float(both[b])
    assert float(both[3]) == 0.0        # pose outside the map
    assert len(set(both.tolist())) > 1
